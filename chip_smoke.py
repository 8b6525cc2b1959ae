#!/usr/bin/env python3
"""Smoke run of nomad_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (one JSON line each, with its seconds):

  1. build    — compile the CUDA kernels (nomad_tpu_torch/csrc) with nvcc
                for sm_90a and load them;
  2. kernels  — every kernel against its plain PyTorch twin on the card,
                array-equal: the compact solve at the c2m bucket (10240
                nodes, 128 groups, 1024-wide readback) on seeded random
                and all-tied inputs and with negative free capacity, and
                where its cluster selection can go wrong (compact_cases:
                several selection rounds, groups cut by k, Np 100352 with
                its slices in shared and in global memory, Np 256 and
                1024 leaving blocks empty); the
                dense and the preemption solves at the preempt wave's
                bucket (10240 nodes, 80 groups, 4 tier rows) on seeded
                random, all-tied and negative-free inputs and with tier
                limits at, past and before the padded tier row, and the
                preemption solve's select edges (preempt_edge_cases:
                counts past every unit, no phase-2 remainder, negative
                tier limits, one-unit tied nodes; Np 100352 with K5's
                slices in global memory), each also through the 8-shard
                solve, whose cached CUDA graph replays other inputs than
                it was captured on; the dense solve's select edges
                (dense_edge_cases: units that all fit, all-tied scores,
                radix passes, count-0 groups; Np 10000 and 100352 with
                K4's slices in global memory); the row set-scatter
                (donated and not) and the clamped row scatter-add, with
                pad indices and negative deltas, K2's one-launch copy's
                edges (scatter_set_cases), and the one-launch add's
                edges (scatter_add_cases: repeated and negative indices,
                4096 rows, rows only the clamp zeroes, a partial last
                block);
  3. main     — the batch solve path at c2m scale through the entry
                points a user calls: 10,000 nodes (4000 MHz / 8192 MB,
                dc1-dc4) and 100 jobs x 1,000 allocs with the kernel.name
                constraint and a datacenter spread; three waves — a full
                resident upload, a delta sync plus an adjusted view for
                stops (uncommitted), and a wave chained on the in-flight
                one. Launch counters are zeroed just before and read just
                after; every kernel must have run;
  4. preempt  — the preemption route at c2m scale (BASELINE config 4,
                bench.py run_preempt_config's shapes): the 10,000 nodes
                filled to 90% with 400 MHz / 800 MB allocs in three
                priority tiers (65 on dc4; 40 and 20 on dc1-dc3), then a
                wave of 20 jobs x 1,000 allocs at priority 70 with the
                constraint and the datacenter spread, in one batch, then
                committed. It runs the preemption kernel on 80 spread
                sub-groups and the dense kernel on the dc4 sub-groups'
                leftovers. Launch counters are zeroed just before the
                wave and read just after; both kernels must have run;
  5. drain    — the per-eval entry point a Nomad server's workers call
                (Harness.process -> new_scheduler -> TPUGenericScheduler /
                TPUSystemScheduler, backend "gpu") on BASELINE config 5
                with an overlapping rollout, at c2m's width (config 5
                as bench.py defines it runs in `small`, and never sends
                K2 a non-donated call): 10,000 nodes, a
                system and a sysbatch job (100 MHz / 64 MB, bench.py
                run_drain_config's), 20 service jobs x 1,000 allocs with
                the constraint and the spread, one eval at a time; then
                a seeded 10% of the nodes drained with migrate marks
                while every service rolls a new version, and every
                affected eval processed (K2 not donated, then K1, per
                service eval, on one warm ResidentClusterState); then
                the host oracle's routes on the same fleet (a sticky-disk
                destructive update, failed allocs rescheduled off their
                penalty nodes, a batch re-solved by solve_host_fallback).
                Every alloc placed, none left on a drained node, no node
                over capacity; K1 >= 40 and K2 not donated >= 1 launches
                with the counters zeroed just before. It prints each eval
                group's stage times;
  6. server   — the server's scheduling pipeline through its own entry
                points: the port's Server with the GPU batch worker
                (TPUBatchWorker, batches of 8 as bench.py
                run_pipeline_config drains them), c2m's 10,000 nodes
                registered through raft, then c2m's 100 jobs x 1,000
                allocs, each through Server.job_register (broker ->
                phase A on the solve thread -> phase B on the commit
                thread -> plan queue -> applier -> FSM, the commit on
                the C fastpack), then a roll wave (20 new jobs and 4 of
                wave 1's scaled to 500 while rolling a new version) whose
                stops ride chained batches. Launch counters zeroed just
                before the first register, read after the roll: K1 for
                every compact batch, K3 at least once; 100,000 then
                118,000 live allocs, no node over capacity, every eval
                complete, no device failover or failed batch, the
                worker's resident tensors and every tensor its K1-K3
                calls took or gave on cuda:0, the C fastpack loaded.
                It records the first call of K1, of K2 donated and not
                and of K3, which replay holds against their twins. It
                prints the walls, jobs/s and allocs/s, the
                batch counts and the batch traces' summed spans; then
                server.failover (one injected retriable DeviceFault at
                the device wait: exactly one failover, that batch
                re-solved by solve_host_fallback, every alloc placed),
                server.system (a system job, then a new node that the
                system worker places it on) and server.overlap (the
                first SERVER_OVERLAP_JOBS of those jobs on fresh
                servers, serial, pipelined, pipelined, serial, all
                traced: the walls and the overlap ratio, a number to
                record, not a gate; cut from 100 jobs to 40 when the
                tenancy phase came, to keep the run's time);
  7. pool     — the solver pool (nomad_tpu's server/solver_pool.py and
                scheduler/tpu/remote_solve.py, ported) over the port's RPC
                fabric: the port's Server as leader (the GPU batch worker,
                batches of 8, pipelined) and two solver-role members, each
                node an RPCServer on 127.0.0.1 with a shared secret, a
                ConnPool, a gossip Membership and a SolverPool, wired as
                nomad_tpu's ClusterServer wires them; the members' hosts
                read the leader's store (the port has no raft
                replication: perfectly synced replicas, as bench.py's
                c2m_pool). pool.c2m: each member warmed once through
                SolverPool.Sync over RPC, then c2m's first 50 jobs
                (POOL_C2M_JOBS, cut for the run's time) and the
                server phase's roll wave through Server.job_register,
                every batch dispatched to a member, launch counters zeroed
                just before the first register and read after the roll:
                50,000 then 68,000 live allocs, no node over capacity,
                every eval complete, no local fallback, member fault or
                device failover, each member warmed once and solving, its
                resident tensors on cuda:0, K1 launched once per compact
                solve on a member, K2 not donated at least once; each
                member's first K1 and K2 calls held against their twins;
                it prints the walls, rates, partial commits (a remote
                batch never chains, so the applier trims overlapping
                batches), the summed solver.pool.dispatch and
                solver.pool.remote spans and the request and reply bytes
                per batch. pool.failover: a faultplane drop on one
                member's SolverPool.Solve: exactly one member fault and
                one device failover, that batch re-solved by
                solve_host_fallback, every later batch on the surviving
                member, every alloc placed. pool.lockstep: one member,
                the worker driven by hand, c2m's first 4 batches each
                solved on one snapshot on the leader's card and through
                the member over RPC: identical placements. pool.scaling:
                bench.py's c2m_pool shapes (2,000 nodes, 6 batches of 8
                jobs x 100) with 1 and 2 members, in the order 1, 2, 2,
                1: evals/s and the ratio, recorded, not gated;
  7b. codec  — the wire codec (nomad_tpu's native/fastpack.c pack,
                register_class and wire_rows, ported, and an unpack of
                the port's own): one solver-pool reply at c2m's width
                (CODEC: RemoteSolver.solve of 8 of c2m's jobs on c2m's
                10,000 nodes in one batch, small_batch_threshold 0; K1
                launched, its first call held against its twin), packed
                and unpacked through the C fastpack, timed: its bytes and
                the encode and decode seconds. The C bytes must equal
                the Python writer's and pack again to themselves after
                the round trip, one PlacementBatch's bytes must decode to
                one wire form through C and the Python reader, and every
                fastpack entry point must be live (a missing compiler or
                extension fails the run);
  8. lifecycle — the job lifecycle (nomad_tpu's server/job_plan.py,
                deployment_watcher.py, drainer.py, periodic.py, ported)
                through the Server's own endpoints on c2m's 10,000 nodes,
                the GPU batch worker pipelined in batches of 8 with
                small_batch_threshold 0 (every solve on the card) and the
                deployment watcher, node drainer and periodic dispatcher
                on their threads. Setup: 20 of c2m's jobs x 1,000 allocs
                with an update stanza (max_parallel 250, canary 10,
                min_healthy_time 0, healthy_deadline 5m, auto_revert) and
                a migrate stanza (max_parallel 100), each first
                deployment driven to successful. Then, with the launch
                counters zeroed: lifecycle.plan (Server.job_plan of a
                21st job and of job 0 with a new task env: 1,000 creates,
                10 canaries, nothing written, K1 per plan, each plan's
                ms); lifecycle.deploy (4 jobs rolled: 10 canaries each
                placed, marked healthy, promoted, then rolled 250 at a
                time, each step marked healthy, until 4,000 allocs run
                the new version and each deployment is successful and
                its version stable); lifecycle.revert (job 5's canaries
                marked unhealthy: the watcher fails the deployment and
                reverts to a version whose spec equals the stable one's,
                the canaries stopped, 1,000 allocs on the stable spec);
                lifecycle.drain (a seeded 10% of the nodes drained with a
                deadline an hour away: two drainer passes, each marking
                at most 100 per group and timed, every replacement
                reported running, then the deadline forced; no alloc
                left on a drained node, each drained node's strategy
                cleared and ineligible, every group back at its count);
                lifecycle.periodic (a */5 prohibit_overlap batch job's
                child by PeriodicDispatch.force_launch and a
                parameterized job's by Server.job_dispatch, 100 allocs
                each). Health is reported through alloc_set_health and
                update_allocs_from_client (LIFE_HEALTH: no client runs).
                No device failover or failed batch, the resident tensors
                on cuda:0, every eval complete, no node over capacity,
                K1 once per compact batch and per plan, K2 not donated at
                least once. Each step prints its wall, evals, batches,
                watcher passes and summed spans;
  9. tenancy  — the tenancy and cluster tables (nomad_tpu's namespaces,
                acl/, CSI volumes with their claims and
                server/volume_watcher.py, services, secrets and Vault
                task tokens, scaling policies, server/search.py,
                server/watch_hub.py and stream/ with state/events.py,
                ported) through the Server's own endpoints at c2m's
                width (TEN), the GPU batch worker pipelined in batches
                of 8 and every watcher thread running, one event-stream
                subscription over every topic held across the phase.
                tenancy.setup: c2m's 10,000 nodes (dc1's 2,500 with a
                healthy node-capable CSI plugin `ebs`) through
                Server.node_register from 32 threads, coalesced by the
                NodeRegisterBatcher (the entry count printed), then the
                heartbeat wheel switched off (no client runs); default
                bootstrapped at leadership, team-a and team-b upserted,
                a job into team-c refused with the store unmoved (C1);
                ACL bootstrap, a team-a submit-job policy, a token for it
                resolved. tenancy.volumes: a multi-writer CSI volume
                `data` and a single-writer `solo` in team-a; 4 c2m jobs
                asking for `data`: all 4,000 allocs on dc1 (the screen
                masks K1 to the plugin's 2,500 nodes, checked on the
                recorded call), 4,000 claims each written in its alloc's
                commit; a count-1 job claims `solo`, a second is blocked,
                the first stopped, the volume watcher releases its claim
                and the second places and claims; deregistering `data`
                refused. tenancy.jobs: 16 c2m jobs with a scaling stanza
                across the three namespaces (16 policies synced), one
                job_scale (one scaling event), prefix_search.
                tenancy.services: a registration per alloc of one job,
                a get_client_allocs watch through the watch hub on a dc1
                node woken by the job's stop, half the rows dropped by
                services_deregister_alloc and the rest by service_gc.
                tenancy.secrets: secret_upsert; with the Vault allowlist
                set, a job inside it admitted and one of its allocs
                deriving and renewing a task token, a job outside it
                refused at admission, a token derived with the TTL
                shortened on the instance swept by token_gc. Each step
                prints its wall, its kernel launches, its events by topic
                (checked against its writes) and its summed spans (with
                events.publish, the stream's share of the FSM apply). No
                device failover or failed batch, every eval complete, no
                node over capacity; K1 in the volumes and jobs steps;
  10. cluster — replication and the cluster (nomad_tpu's
                server/raft_replication.py, raft_store.py, cluster.py,
                blackbox_wire.py and testing/chaos.py, ported): three
                ClusterServers (ChaosCluster, a durable raft log per data
                dir) over the port's fabric at c2m's width, the leader's
                GPU batch worker pipelined in batches of 8.
                cluster.setup: the servers boot and elect; c2m's 10,000
                nodes through the two followers' Node.register over the
                fabric from 32 threads, forwarded to the leader and
                coalesced by its NodeRegisterBatcher. cluster.c2m: c2m's
                first 25 jobs through a follower's Job.register (each
                acked once the call returns) until all three stores hold
                25,000 live allocs. cluster.failover: the leader killed,
                the seconds to a new leader and to the end of its
                establish_leadership (the replay barrier first), the
                next 25 jobs through the surviving follower until both
                live stores hold 50,000 (CLUSTER: 50 of c2m's 100 jobs,
                cut for the run's time); the new leader's worker starts
                cold: its first sync a full upload, then K2 delta syncs.
                cluster.restart: the killed server from its data dir, the
                entries it reloaded from raft.db and the seconds until it
                caught up; all three stores equal alloc for alloc (id,
                node, resources, desired and client status, indexes) and
                table for table. Each step prints its wall, kernel
                launches and resident syncs, leader changes and elections
                (numbers to record, not gates), the raft entries and
                payload bytes it wrote by type, nomad.raft.apply_seconds'
                count and sum, the AppendEntries calls and bytes, the
                largest replication lag (leader commit to the last live
                follower's apply), the collector's passes (each stops
                all three servers), registrations retried through
                leadership churn, batches nacked by it, and its summed
                batch spans. Then no acked job lost and no duplicate
                alloc (check_invariants), no node over capacity, every
                eval complete, no device failover, no failed batch but
                those nacked by leadership churn (they redeliver to the
                next leader), no raft log compacted, K1 once for every
                compact solve before and after the failover, both
                leaders' resident tensors and every tensor of their K1-K3
                calls on cuda:0; the serialize() bytes and seconds of
                the store cut to its first 2,000 nodes and 20 jobs with
                their allocs (SNAPSHOT) beside MAX_FRAME (a number to
                record); shutdown
                leaves no batch-worker thread. No client runs: each
                server's heartbeat TTL floor is an hour; the heap the
                earlier phases left is frozen out of the collector while
                the cluster runs (FrozenHeap);
  11. agent   — the operator's front door (nomad_tpu's jobspec/parse.py,
                acl/enforce.py, api/, agent/ and cli/, ported) as an
                operator drives it: one server agent (Agent with
                server_enabled, use_tpu_batch_worker, device "cuda", a
                durable raft log in a temp dir; no client runs, so its
                heartbeat TTL floor is an hour), its batch worker in
                batches of 8 as in the server phase. agent.setup: the
                agent boots and leads; c2m's 10,000 nodes through its
                Node.register over the fabric from 32 threads.
                agent.c2m: c2m's job (make_job's shape) written as HCL
                (C2M_HCL), the first through the CLI's `job plan`
                in-process (exit 1: changes; its ms), then all 100 through
                `job run -detach -address http://...`, one after another,
                with one /v1/event/stream subscriber (Job and Allocation
                topics) running; the wait is blocking queries on
                /v1/evaluations?index= with the store polled beside them
                (an eval sitting out the nack delay). It prints the wall
                from the first register to the last eval complete,
                jobs/s, allocs/s, the CLI's ms per job, the blocking
                queries, kernel launches and resident syncs, and the
                summed batch spans. agent.read: `job status` of one job
                through the CLI; /v1/job/<id>/allocations for the first 20
                jobs (all 100 until the client phase came; cut to keep
                the run's time) through NomadClient (20,000 allocs:
                bytes, HTTP seconds,
                decode seconds), each job's allocs equal to the store's
                alloc for alloc; /v1/metrics as JSON and as Prometheus
                text (the nomad.broker, nomad.plan_queue, nomad.workers
                and nomad.fleet providers with their live values); the
                subscriber's events by topic and type; `operator solver
                status` through the CLI (K1's launches and shapes in its
                ledger, the card's memory). Then: every eval complete,
                100,000 live allocs, no node over capacity, no device
                failover or failed batch, K1 once for every compact solve,
                the resident tensors and every K1/K2 tensor on cuda:0, and
                no thread the phase started left after the agent's
                shutdown;
  12. client  — the client (nomad_tpu's client/, drivers/, plugins/
                and devices/plugin.py, ported) running tasks on this
                host: one server agent with a co-located client (agent
                -dev's shape with a durable raft log, the batch worker
                on cuda:0 in batches of 8, its node in dc1) and three
                client agents joined over the fabric (dc2-dc4), each
                node carrying meta real = "1". client.setup: c2m's
                10,000 nodes through Node.register from 32 threads
                beside the four real ones; 10,004 ready, each real node
                with the mock, raw_exec and exec drivers detected and
                the card as nvidia/gpu with its UUID. client.run: c2m's
                job as HCL (CLIENT_HCL: its ask, constraint and spread,
                plus meta.real, the mock driver running until stopped,
                an update stanza, a migrate stanza and a migrating
                ephemeral disk) through `job run` at C2M's density, 330
                allocs a real node (BASELINE.md:11), cut where a node's
                capacity, pinned to the host's cores at 2,300 MHz and
                12,288 MB each (CLIENT), fits fewer (real_per_node); the
                seconds to all running and to the deployment's
                `successful`, Node.update_allocs calls and the allocs
                they carried, K1's launches and shapes, the spans, the
                peak threads. client.exec: a raw_exec task given
                nvidia/gpu and an exec task on every real node; `alloc
                logs` shows CUDA_VISIBLE_DEVICES = the card's UUID,
                `alloc exec <id> echo hi` prints hi and exits 0 (a CLI
                process of its own), `alloc fs` lists the task dir; each
                stream's path (the forward dial or a reverse session).
                client.drain: `node drain -enable` on dc4's node; its
                allocs migrate to dc1-dc3 through the allocwatcher's
                previous-alloc wait. client.restart: dc3's client agent
                stopped with its tasks running (Client.shutdown(
                kill_allocs=False)) and started on its data dir: the same
                node id, the raw_exec and exec tasks reattached with
                their pids, none restarted, its mock allocs ending as
                client_lockstep's. client.stop: `job stop` of both jobs,
                every alloc complete and every task process gone.
                client.devices (client_devices): a server agent whose
                co-located client runs the external TPUDevice plugin
                (nomad_tpu_torch.devices.tpu) in mock mode, 4 instances,
                over the plugin fabric, and a client agent without it;
                a batch job of two allocs asking 2 google/tpu each
                lands on the plugin's node through the card's batch
                worker with disjoint instances, each task's env carrying
                its own in TPU_VISIBLE_DEVICES; K1 >= 1, its first call
                held against its twin;
  13-15 run in a process of their own (harness_phases), each with its
                counters zeroed around it and its first K1-K3 calls
                replayed against their twins there: a fleet's heartbeats
                share one interpreter with its server, and what the
                earlier phases leave behind starves them;
  13. fleet   — nomad_tpu's testing/fleet.py, ported: run_fleet_scale at
                bench.py's fleet settings (FLEET: one server, TTL 10 s,
                8 driver threads, 8 real watchers, a 20% partition, 10
                jobs/s, the register deadline max(60, n / 50), the p99
                and cpu-per-node bounds) at c2m's 10,000 simulated
                nodes, steady state cut to 60 s, the GPU batch worker on
                cuda:0 for batches of 8 or more placements, and c2m's
                job (1,000 allocs) registered once the fleet is in: the
                registration storm through the node door, heartbeats
                re-arming the TTL wheel, a mass expiry and a mass
                reconnect, job traffic throughout; registered_all,
                expiry_detected and
                _batched, reconnect_recovered and _batched, converged,
                invariants_ok, c2m's job live in full and K1 >= 1
                gate; hb_p99_s,
                per_node_cpu_fraction, admission_engaged, the storms'
                raft entries and batch sizes and device.wait against
                the wall are printed;
  14. soak    — nomad_tpu's testing/loadgen.py, ported: run_soak at
                bench.py's soak settings (SOAK: 3 servers, 30 s at 120
                evals/s offered, seed 42, admission depth 96, RPC rate
                40 / burst 80, the partition cycle, faults on, p99
                bound 15 s), the GPU batch worker on cuda:0;
                invariants_ok, converged, K1 >= 1, and every device
                failover of the worker (nomad.worker.device_failover)
                backed by an injected device fault that fired, gate;
  15. scenarios — nomad_tpu's testing/scenarios.py, ported: the spot
                churn (seed 31, 4 cycles, the GPU batch worker) and the
                solver pool's member death and warm leader failover on
                three ClusterServers whose stores are raft replicas
                (seed 43), on cuda:0, with tests/test_torch_scenarios.py's
                gates; K1's launches by pool member are printed;
  16. racecheck — nomad_tpu's testing/racecheck.py, ported: the
                pipelined Server with the GPU batch worker on cuda:0 and
                a modeled 0.2 s device round-trip under the lock-order
                detector, in a process of its own (RACE), stopped
                mid-batch and restarted: K1 >= 1, zero inversions, an
                export of
                repo-relative keys only, fed to the port's nomad-vet
                NV-lock-order cross-check with zero findings;
  17. mesh    — the node-sharded route (kernels also checks the sharded
                solves against their twins and the single-card kernels at
                c2m_sharded's bucket, Np 100352 on 1 and 8 shards, with
                unit caps of 1 for several selection rounds and with lists
                cut by k, and at the preempt wave's, on 8 shards): bench.py
                run_c2m_sharded_config's shapes at full width, 100,000
                nodes and rounds of 16 jobs x 500 allocs, round 1 solved
                on one snapshot without a mesh, on 1 shard and on 8 (the
                plans must be identical), then five pipelined rounds on
                8 shards (a full upload, chained in-flight batches, delta
                syncs) with the counters zeroed; then the preempt phase's
                fleet and wave solved on one snapshot on one card and on
                8 shards (identical placements and victims), the mesh's
                plans committed. It prints the shard -> card map;
  18. replay  — each kernel's first call on its path replayed against its
                twin, and timed beside its bound and the twin's time (K2
                not donated also at the drain path's first such call, on
                scatter_set_cases' edges, and beside index_copy): a
                kernel's `ms` is its device time (CUDA events around
                back-to-back launches queued behind a spin kernel) and
                `enqueue_ms` the host's time to queue one call; K5's and
                K7's device time split by kernel must show the radix
                select's kernels and no pick loop, and K7's timed calls
                must replay its CUDA graph (`launch_route`,
                `graph_replays`, `capture_s`); K4's and K5's must show
                their cluster kernel alone, with its launch shape; K1-K3
                also at the server phase's first calls (`server`,
                `server_copy` in their lines, exact, timed beside their
                bounds), K1 and K2 not donated at the lifecycle phase's
                (`lifecycle`, `lifecycle_copy`), K1 at the tenancy
                phase's first masked call (`tenancy`, with the nodes its
                live groups may place on), K1-K3 at the cluster phase's
                first calls (`cluster`), K1 (and K2, where it ran) at
                the agent phase's (`agent`), the client phase's
                (`client`), and the fleet's, soak's and scenarios'
                (`fleet`, `soak`, `scenarios`);
  19. small   — the same three waves at 200 nodes, and at 500 nodes on
                an 8-shard mesh, bench.py's 500-node preempt config, its
                1,000-node drain config (20 x 100 service allocs, one
                system job, 100 nodes drained, one eval at a time) and
                its pipeline config (2,000 nodes, 64 jobs x 300 allocs,
                the batch worker driven by hand in batches of 8, each
                solved while its parent's commit is pending), and the
                lifecycle's five steps at 200 nodes (20 jobs of 50,
                canary 2, max_parallel 10, migrate 5) with every batch
                and watcher pass driven by hand (lifecycle_lockstep,
                which tests/test_torch_lifecycle.py also runs against
                nomad_tpu's Server), and the tenancy steps at 200 nodes
                (TEN_SMALL: jobs of 50, the fleet from one thread) with
                every batch and watcher pass driven by hand
                (tenancy_lockstep, which tests/test_torch_tenancy.py also
                runs against nomad_tpu's Server), and the cluster at 200
                nodes (CLUSTER_SMALL: three servers, jobs of 50, each
                through a follower with its eval complete before the
                next, a leader kill, more jobs, a restart, one job scaled;
                cluster_lockstep, which tests/test_torch_cluster.py also
                runs against nomad_tpu's ClusterServer), and the server
                agent at 200 nodes (AGENT_SMALL: six HCL jobs of 50
                through the CLI's `job run`, each eval complete before
                the next, then a fixed list of HTTP reads;
                agent_lockstep, which tests/test_torch_agent.py also runs
                against nomad_tpu's agent), and a dev agent and a client
                agent (CLIENT_SMALL: 200 nodes and two real ones, two
                mock jobs of 20 and a raw_exec task through a drain, a
                client agent's restart and a stop; client_lockstep, which
                tests/test_torch_client.py also runs against nomad_tpu's
                agents), on the card and on the CPU
                twins: identical placements, victims, eval outcomes,
                chain verdicts, plans, deployments, job versions, drain
                marks, claims, services, scaling policies and events, ACL
                and secret tables and the event sequence, every cluster
                server's store equal to the others', and the agent's HTTP
                bodies with minted ids named by what they name.

Then the card's name and power limit (nvidia-smi), one {"kernels": [...]}
line (every kernel also carries `server_launches`, its count in the
server phase, `pool_launches`, its count in pool.c2m, and
`lifecycle_launches`, its count in the lifecycle phase,
`tenancy_launches`, its count in the tenancy phase,
`cluster_launches`, its count in the cluster phase,
`agent_launches`, its count in the agent phase,
`codec_launches`, its count in the codec phase,
`client_launches`, its count in the client phase, and
`fleet_launches`, `soak_launches` and `scenarios_launches`, its counts
in those phases; K1 and K2 `pool`,
each member's first call held and timed), and last {"ok": true,
"device": {...}}. Any failure raises: the exit code is nonzero and no
result line is printed. Without a CUDA
device it exits 2 before doing anything.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import re
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

from nomad_tpu_torch import mock, trace
from nomad_tpu_torch.scheduler import SchedulerConfig
from nomad_tpu_torch.scheduler import gpu
from nomad_tpu_torch.scheduler.gpu import kernels as tk
from nomad_tpu_torch.scheduler.gpu import libkernels
from nomad_tpu_torch.scheduler.gpu import solver as solver_mod
from nomad_tpu_torch.structs import Constraint, Spread
from nomad_tpu_torch.structs.node_class import compute_node_class
from nomad_tpu_torch.structs.structs import (
    ALLOC_CLIENT_STATUS_FAILED,
    DesiredTransition,
    DrainStrategy,
)
from nomad_tpu_torch.testing import Harness

DCS = ["dc1", "dc2", "dc3", "dc4"]

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# f32 operations per (group, node) of the compact solve's scoring pass:
# 2 int->float adds, 2 max, 2 div, 2 sub, 2 mul, 2 exp, add, sub, 2 clamp,
# div, bias add
SCORE_FLOPS = 19

SOURCES = {
    "solve_placement_compact": (
        "nomad_tpu_torch/csrc/solve_compact.cu",
        "nomad_tpu/scheduler/tpu/kernels.py:213",
    ),
    "solve_placement": (
        "nomad_tpu_torch/csrc/solve_dense.cu",
        "nomad_tpu/scheduler/tpu/kernels.py:192",
    ),
    "solve_placement_preempt": (
        "nomad_tpu_torch/csrc/solve_dense.cu",
        "nomad_tpu/scheduler/tpu/kernels.py:360",
    ),
    "scatter_rows": (
        "nomad_tpu_torch/csrc/scatter_rows.cu",
        "nomad_tpu/scheduler/tpu/solver.py:427",
    ),
    "scatter_add_rows": (
        "nomad_tpu_torch/csrc/scatter_rows.cu",
        "nomad_tpu/scheduler/tpu/solver.py:459",
    ),
    "sharded_solver": (
        "nomad_tpu_torch/csrc/solve_sharded.cu",
        "nomad_tpu/scheduler/tpu/kernels.py:583",
    ),
    "sharded_solver_preempt": (
        "nomad_tpu_torch/csrc/solve_sharded.cu",
        "nomad_tpu/scheduler/tpu/kernels.py:475",
    ),
}


def phase(name: str, t0: float, **extra) -> None:
    print(json.dumps({"phase": name, "seconds": time.perf_counter() - t0,
                      **extra}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds per call, each call between two CUDA events:
    the host's dispatch between the events is counted too. For the plain
    twins, whose index masks wait on the card inside the call. A call
    whose warmup took over a second (the plain twins of K1 at c2m's
    width and of K7, 2-9 s a call) is timed once."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if warmup and (time.perf_counter() - t0) / warmup > 1.0:
        reps = 1
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int) -> tuple:
    """(device ms per call, host enqueue ms per call) for a function that
    only queues work. A spin kernel holds the card while the host queues
    `reps` calls, so the events around the calls see them back to back
    on the card, with none of the host's time between them. Fails if the
    spin ended before the host had queued every call. The collector is
    paused while the calls are queued, so a pass of it over a phase's
    heap cannot hold the queue past the spin."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # ~10 ms at the H100's boost clock
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        gc.disable()
        try:
            torch.cuda._sleep(cycles)
            a.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host_s = time.perf_counter() - t0
            b.record()
        finally:
            gc.enable()
        covered = not a.query()
        b.synchronize()
        if covered:
            return a.elapsed_time(b) / reps, 1e3 * host_s / reps
        cycles *= 4
    raise AssertionError("the spin kernel never outlasted the enqueue")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def compact_problem(rng, n=10240, g=128, tied=False, negative=False):
    """Seeded inputs in the shape of tests/test_tpu_solver.py _c1k_problem
    at the c2m bucket, as the solver ships them (bit-packed feasibility,
    i16 unit caps)."""
    if tied:
        cap = np.full((n, 3), 4000, dtype=np.int32)
        used = np.zeros((n, 3), dtype=np.int32)
        asks = np.tile(np.array([[250, 128, 150]], np.int32), (g, 1))
        counts = rng.integers(0, 1000, g).astype(np.int32)
        feas = np.ones((g, n), dtype=bool)
        bias = np.zeros((g, n), dtype=np.float32)
    else:
        cap = rng.integers(2000, 8000, size=(n, 3)).astype(np.int32)
        used = (cap * rng.uniform(0.0, 0.5, size=(n, 3))).astype(np.int32)
        asks = rng.integers(100, 600, size=(g, 3)).astype(np.int32)
        counts = rng.integers(1, 1000, size=g).astype(np.int32)
        feas = rng.random((g, n)) > 0.15
        bias = (rng.random((g, n)) * 0.2).astype(np.float32)
    if negative:
        rows = rng.random(n) < 0.3
        used[rows] = cap[rows] + rng.integers(1, 700, (int(rows.sum()), 3))
    ucap = rng.integers(0, 40, (g, n)).astype(np.int16)
    idx = np.arange(g, dtype=np.int32)
    return [cap, used, asks, counts, np.packbits(feas, axis=1), idx, bias,
            idx, ucap, idx]


def dense_problem(rng, n=10240, g=80, tiers=3, tied=False, negative=False):
    """Seeded inputs in the shape of tests/test_tpu_solver.py _c1k_problem's
    preempt variant at the preempt wave's bucket: nearly-full nodes whose
    usage is mostly low-tier, the cumulative tier prefix padded to 4 rows
    (the padded rows repeat the full sum, as the solver pads it), and tier
    limits from -1 to past the pad. Returns (K4 args, K5 args)."""
    tp = 4
    if tied:
        cap = np.full((n, 3), 4000, dtype=np.int32)
        used = np.full((n, 3), 3600, dtype=np.int32)
        asks = np.tile(np.array([[400, 400, 100]], np.int32), (g, 1))
        counts = rng.integers(0, 300, g).astype(np.int32)
        feas = np.ones((g, n), dtype=bool)
        bias = np.zeros((g, n), dtype=np.float32)
        tier_usage = np.full((tiers, n, 3), 3600 // tiers, dtype=np.int32)
    else:
        cap = rng.integers(2000, 8000, size=(n, 3)).astype(np.int32)
        used = (cap * rng.uniform(0.75, 0.95, size=(n, 3))).astype(np.int32)
        asks = rng.integers(100, 600, size=(g, 3)).astype(np.int32)
        # _c1k_problem's counts per 1024 nodes, scaled to n
        counts = (rng.integers(40, 200, size=g) * (n // 1024)).astype(np.int32)
        feas = rng.random((g, n)) > 0.15
        bias = (rng.random((g, n)) * 0.2).astype(np.float32)
        shares = rng.dirichlet(np.ones(tiers), size=n)[:, :, None]
        tier_usage = (
            used[:, None, :] * 0.9 * shares
        ).astype(np.int32).transpose(1, 0, 2)
    if negative:
        rows = rng.random(n) < 0.3
        used[rows] = cap[rows] + rng.integers(1, 700, (int(rows.sum()), 3))
    ucap = rng.integers(0, 40, (g, n)).astype(np.int32)
    prefix = np.zeros((tp, n, 3), dtype=np.int32)
    prefix[1:tiers + 1] = np.cumsum(tier_usage, axis=0)
    prefix[tiers + 1:] = prefix[tiers]
    tier_limit = rng.integers(-1, tp + 2, size=g).astype(np.int32)
    return ([cap, used, asks, counts, feas, bias, ucap],
            [cap, used, prefix, asks, counts, feas, bias, ucap, tier_limit])


def mesh_problem(rng, n=100352, g=16, tied=False, negative=False):
    """Dense inputs at c2m_sharded's bucket (100,000 nodes padded to
    100352, 16 groups of up to 500 instances), in the shape of
    compact_problem: random, all-tied, or 30% of the nodes over
    capacity."""
    if tied:
        cap = np.full((n, 3), 4000, dtype=np.int32)
        used = np.zeros((n, 3), dtype=np.int32)
        asks = np.tile(np.array([[250, 128, 150]], np.int32), (g, 1))
        feas = np.ones((g, n), dtype=bool)
        bias = np.zeros((g, n), dtype=np.float32)
    else:
        cap = rng.integers(2000, 8000, size=(n, 3)).astype(np.int32)
        used = (cap * rng.uniform(0.0, 0.5, size=(n, 3))).astype(np.int32)
        asks = rng.integers(100, 600, size=(g, 3)).astype(np.int32)
        feas = rng.random((g, n)) > 0.15
        bias = (rng.random((g, n)) * 0.2).astype(np.float32)
    counts = rng.integers(0, 501, g).astype(np.int32)
    if negative:
        rows = rng.random(n) < 0.3
        used[rows] = cap[rows] + rng.integers(1, 700, (int(rows.sum()), 3))
    ucap = rng.integers(0, 40, (g, n)).astype(np.int32)
    return [cap, used, asks, counts, feas, bias, ucap]


def scatter_problem(rng, n=10240, b=700):
    used = rng.integers(0, 9000, (n, 3)).astype(np.int32)
    idx = np.full(1024, 1 << 30, dtype=np.int32)  # pad indices past b
    idx[:b] = rng.choice(n, size=b, replace=False)
    rows = np.zeros((1024, 3), dtype=np.int32)
    rows[:b] = rng.integers(-6000, 6000, (b, 3))
    return used, idx, rows


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def unit_caps_of_one(arrays, counts_from: int, counts_to: int, rng):
    """A compact_problem whose every node takes at most one instance of a
    group, with counts in [counts_from, counts_to): a group then needs one
    pick per instance, more than one selection round's 16 x 32."""
    arrays = list(arrays)
    arrays[8] = np.ones_like(arrays[8])
    arrays[3] = rng.integers(counts_from, counts_to,
                             arrays[3].shape).astype(np.int32)
    return arrays


def compact_cases(rng) -> list:
    """(name, arrays, max_count) for K1: the c2m bucket's random, all-tied
    (ties straddle every block slice) and negative-free problems; groups
    needing several selection rounds (unit caps of 1, counts past 512);
    groups cut by k; Np 100352 (c2m_sharded's bucket) with i16 unit caps,
    whose slices fit in shared memory, and with i32 caps, whose slices do
    not (the global-memory variant); and Np 256 and 1024, which leave
    blocks of the cluster with part of a slice or none."""
    def caps32(arrays):
        arrays = list(arrays)
        arrays[8] = arrays[8].astype(np.int32)
        return arrays

    return [
        ("random", compact_problem(rng), 1024),
        ("tied", compact_problem(rng, tied=True), 1024),
        ("negative_free", compact_problem(rng, negative=True), 1024),
        ("multi_round", unit_caps_of_one(compact_problem(rng, g=32),
                                         600, 1000, rng), 1024),
        ("tied_multi_round", unit_caps_of_one(
            compact_problem(rng, g=16, tied=True), 600, 1000, rng), 1024),
        ("cut_by_k", unit_caps_of_one(compact_problem(rng, g=32),
                                      100, 1000, rng), 64),
        ("np100352", compact_problem(rng, n=100352, g=16), 1024),
        ("np100352_global_slices",
         caps32(compact_problem(rng, n=100352, g=16)), 1024),
        ("np1024", compact_problem(rng, n=1024, g=24), 256),
        ("np256_tied", compact_problem(rng, n=256, g=24, tied=True), 256),
    ]


def preempt_edge_cases(rng) -> list:
    """(name, K5 arguments) where the preemption solve's radix select can
    go wrong, at the preempt wave's bucket with 16 groups: counts past
    every unit a group can take (the shortcut, in both phases); low usage
    and small counts (phase 1 places everything, no phase 2); tier limits
    from -8 to -1 (wrapped from the end, then clamped); all scores tied
    with unit caps of 1 (the boundary inside a run of one-unit nodes); and
    Np 100352 (c2m_sharded's bucket), where K5's slices do not fit in
    shared memory."""
    cases = []
    _, k5 = dense_problem(rng, g=16)
    k5[4] = np.full_like(k5[4], 1_000_000)
    cases.append(("count_past_units", k5))
    _, k5 = dense_problem(rng, g=16)
    k5[1] = (k5[0] * 0.3).astype(np.int32)
    k5[4] = rng.integers(1, 200, k5[4].shape).astype(np.int32)
    cases.append(("no_phase2", k5))
    _, k5 = dense_problem(rng, g=16)
    k5[8] = rng.integers(-8, 0, k5[8].shape).astype(np.int32)
    cases.append(("negative_tier", k5))
    _, k5 = dense_problem(rng, g=16, tied=True)
    k5[7] = np.ones_like(k5[7])
    cases.append(("tied_one_unit", k5))
    _, k5 = dense_problem(rng, n=100352, g=8)
    cases.append(("np100352", k5))
    return cases


def preempt_edge_checks(dev, rng) -> None:
    """K5 and K7 (8 shards, one card) against their twins on
    preempt_edge_cases, with what each case is for checked on the twin's
    outputs; then the first case again through K7's cached graph, which
    has replayed the other cases' inputs since (stale static buffers
    would show)."""
    variants, routes, first = set(), [], None
    for name, arrays in preempt_edge_cases(rng):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        want = tk.solve_placement_preempt_plain(*t)
        got = tk.solve_placement_preempt(*t)
        torch.cuda.synchronize()
        launch = tk.solve_placement_preempt.last_launch
        check(max_abs_err(got, want) == 0,
              f"preempt {name}: K5 differs from its twin (launch {launch})")
        variants.add(launch["smem_slices"])
        got = tk.sharded_solver_preempt(*t, n_shards=8)
        torch.cuda.synchronize()
        routes.append((t[0].shape[0], tk.sharded_solver_preempt.last_route))
        check(max_abs_err(got, tk.sharded_solver_preempt_plain(
            *t, n_shards=8)) == 0, f"sharded preempt {name}: K7 differs "
            "from its twin")
        assign, evict = want[0], want[1]
        counts = t[4]
        if name == "count_past_units":
            check(bool((assign.sum(dim=1) < counts).all()),
                  "count_past_units: a group placed its whole count")
        if name == "no_phase2":
            check(int(evict.sum()) == 0
                  and bool((assign.sum(dim=1) == counts).all()),
                  "no_phase2: phase 1 left a remainder")
        check(int(assign.sum()) > 0, f"preempt {name}: placed nothing")
        first = first or (t, want)
    check(variants == {True, False},
          "K5's shared- and global-memory slice variants were not both run")
    t, want = first
    got = tk.sharded_solver_preempt(*t, n_shards=8)
    torch.cuda.synchronize()
    check(tk.sharded_solver_preempt.last_route == "graph_replay"
          and max_abs_err(got, want) == 0,
          "K7's graph replayed on its first inputs again differs")
    at_bucket = [r for n, r in routes if n == t[0].shape[0]]
    check(at_bucket[0] in ("graph_capture", "graph_replay")
          and all(r == "graph_replay" for r in at_bucket[1:]),
          f"K7 routes {routes}: the cases did not share one graph")


def dense_edge_cases(rng) -> list:
    """(name, K4 arguments) where the dense solve's cluster kernel can go
    wrong, 16 groups each: counts past every unit (the select's round-0
    shortcut), all scores tied (an index-ordered share), spread scores
    with counts well below the units (radix passes), a batch padded with
    count-0 groups, Np 10000 (not a multiple of 128: the global-memory
    slices) and Np 100352 (c2m_sharded's bucket: global-memory slices)."""
    k4, _ = dense_problem(rng, g=16)
    k4[3] = np.full_like(k4[3], 1_000_000)
    cases = [("all_fit", k4)]
    k4, _ = dense_problem(rng, g=16, tied=True)
    k4[6] = np.ones_like(k4[6])
    cases.append(("all_tied", k4))
    k4 = mesh_problem(rng, n=10240)
    k4[3] = rng.integers(100, 501, k4[3].shape).astype(np.int32)
    cases.append(("radix_passes", k4))
    k4, _ = dense_problem(rng, g=16)
    k4[3][1::3] = 0
    k4[3][8:] = 0
    cases.append(("padded_groups", k4))
    cases.append(("np10000", dense_problem(rng, n=10000, g=16)[0]))
    cases.append(("np100352", mesh_problem(rng)))
    return cases


def dense_edge_checks(dev, rng) -> None:
    """K4 against its twin on dense_edge_cases, array-equal, with what
    each case is for checked on the twin's outputs and both slice
    variants (shared and global memory) run."""
    variants = set()
    for name, arrays in dense_edge_cases(rng):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        got = tk.solve_placement(*t)
        torch.cuda.synchronize()
        launch = dict(tk.solve_placement.last_launch)
        want = tk.solve_placement_plain(*t)
        check(max_abs_err(got, want) == 0,
              f"dense {name}: K4 differs from its twin (launch {launch})")
        variants.add(launch["smem_slices"])
        placed, counts = want[0].sum(dim=1), t[3]
        check(int(placed.sum()) > 0, f"dense {name}: placed nothing")
        if name == "all_fit":
            check(bool((placed < counts).all()),
                  "all_fit: a group's units covered its count")
        if name in ("radix_passes", "all_tied"):
            check(bool((placed == counts).all()),
                  f"{name}: a group was not placed in full")
        if name == "padded_groups":
            check(int(want[0][counts == 0].abs().sum()) == 0,
                  "padded_groups: a count-0 group placed")
        if name.startswith("np"):
            check(not launch["smem_slices"],
                  f"dense {name}: the slices went to shared memory")
    check(variants == {True, False},
          "K4's shared- and global-memory slice variants were not both run")


def scatter_add_cases(rng) -> list:
    """(name, used, idx, rows) where K3's one-launch kernel can go wrong:
    repeated indices (shared atomics on one row), negative indices down
    to -Np and past it, the 1 << 30 pad with nonzero pad rows, 4096 rows
    (more than a block's threads), untouched negative rows that only the
    clamp zeroes, and Np 10000, whose last block owns part of a range."""
    n = 10240

    def base(n_, lo=0):
        return rng.integers(lo, 9000, (n_, 3)).astype(np.int32)

    def deltas(b):
        return rng.integers(-6000, 6000, (b, 3)).astype(np.int32)

    cases = [("repeated", base(n),
              rng.choice(50, size=1024).astype(np.int32), deltas(1024))]
    idx = rng.integers(-n - 40, 0, 1024).astype(np.int32)
    idx[:4] = [-n, -1, -n - 1, -n]
    cases.append(("negative", base(n), idx, deltas(1024)))
    idx = np.full(1024, 1 << 30, dtype=np.int32)
    idx[:300] = rng.choice(n, 300, replace=False)
    cases.append(("pad", base(n), idx, deltas(1024)))
    cases.append(("b4096", base(n), rng.integers(0, n, 4096).astype(np.int32),
                  deltas(4096)))
    idx = np.full(1024, 1 << 30, dtype=np.int32)
    idx[:100] = rng.choice(n // 2, 100, replace=False)
    cases.append(("untouched_negative", base(n, lo=-3000), idx, deltas(1024)))
    n2 = 10000
    idx = rng.integers(n2 - 300, n2, 1024).astype(np.int32)
    cases.append(("np10000", base(n2), idx, deltas(1024)))
    return cases


def scatter_set_cases(rng, path_calls=()) -> list:
    """(name, used, idx, rows) for K2's one-launch non-donated mode:
    `path_calls` (the main path's and the drain path's own calls, as
    host tensors), then an empty update, every pair dropped (the pad and
    indices below -Np), negative indices down to -Np, repeated indices
    (the pair with the highest i must win), 8192 pairs (two of the
    kernel's batches) with repeats, and Np 10000, whose last block owns
    part of a range."""
    n = 10240

    def base(n_):
        return rng.integers(0, 9000, (n_, 3)).astype(np.int32)

    def rows_of(b):
        return rng.integers(0, 9000, (b, 3)).astype(np.int32)

    cases = [(name, u.numpy(), i.numpy(), r.numpy())
             for name, u, i, r in path_calls]
    cases.append(("empty", base(n), np.zeros(0, dtype=np.int32),
                  np.zeros((0, 3), dtype=np.int32)))
    idx = np.full(1024, 1 << 30, dtype=np.int32)
    idx[:200] = rng.integers(-3 * n, -n, 200)
    cases.append(("all_dropped", base(n), idx, rows_of(1024)))
    idx = rng.integers(-n, 0, 1024).astype(np.int32)
    idx[:3] = [-n, -1, -n - 1]
    cases.append(("negative", base(n), idx, rows_of(1024)))
    cases.append(("repeated", base(n),
                  rng.choice(40, size=1024).astype(np.int32), rows_of(1024)))
    idx = rng.integers(0, n, 8192).astype(np.int32)
    idx[4096:4196] = idx[:100]  # a repeat across the two batches
    cases.append(("b8192_repeated", base(n), idx, rows_of(8192)))
    n2 = 10000
    idx = rng.integers(n2 - 300, n2 + 50, 1024).astype(np.int32)
    cases.append(("np10000", base(n2), idx, rows_of(1024)))
    return cases


def scatter_set_checks(dev, rng, path_calls=()) -> int:
    """K2 not donated against its twin on scatter_set_cases, array-equal:
    one launch a call, and the input stays as it was. Returns the number
    of cases."""
    cases = scatter_set_cases(rng, path_calls)
    for name, used, idx, rows in cases:
        u, i, r = (torch.from_numpy(a).to(dev) for a in (used, idx, rows))
        before = tk.scatter_rows.launches
        got = tk.scatter_rows(u, i, r, False)
        check(tk.scatter_rows.launches == before + 1,
              f"scatter_rows {name}: not one launch")
        want = tk.scatter_rows_plain(u, i, r, False)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"scatter_rows {name} differs")
        check(torch.equal(u.cpu(), torch.from_numpy(used)),
              f"scatter_rows {name} wrote its input")
    return len(cases)


def scatter_add_checks(dev, rng) -> None:
    """K3 against its twin on scatter_add_cases, array-equal; the input
    must stay as it was (the output is a fresh tensor)."""
    for name, used, idx, rows in scatter_add_cases(rng):
        u, i, r = (torch.from_numpy(a).to(dev) for a in (used, idx, rows))
        got = tk.scatter_add_rows(u, i, r)
        want = tk.scatter_add_rows_plain(u, i, r)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"scatter_add_rows {name} differs")
        check(torch.equal(u.cpu(), torch.from_numpy(used)),
              f"scatter_add_rows {name} wrote its input")
        check(bool((got == 0).any()), f"scatter_add_rows {name}: no clamp")
        if name == "untouched_negative":
            kept = torch.zeros(used.shape[0], dtype=torch.bool)
            kept[torch.from_numpy(idx[:100]).long()] = True
            neg = (torch.from_numpy(used) < 0).any(dim=1) & ~kept
            check(bool(neg.any()) and int(got.cpu()[neg].min()) == 0,
                  "untouched_negative: no untouched row was clamped")


def kernel_checks(dev, seed: int) -> list:
    """Each kernel against its twin on seeded inputs at the c2m bucket.
    Returns K4's arguments from the random dense case, a call that
    places, for replay_dense to time beside the path's own call."""
    rng = np.random.default_rng(seed)
    variants = set()
    for name, arrays, maxc in compact_cases(rng):
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = tk.solve_placement_compact(*args, max_count=maxc)
        launch = tk.solve_placement_compact.last_launch
        want = tk.solve_placement_compact_plain(*args, max_count=maxc)
        torch.cuda.synchronize()
        for label, g_, w_ in zip(("inst", "over", "used'"), got, want):
            check(torch.equal(g_, w_), f"compact {name}: {label} differs "
                  f"(launch {launch})")
        check(int((got[0] >= 0).sum()) > 0, f"compact {name}: placed nothing")
        variants.add(launch["smem_slices"])
        if name == "np100352_global_slices":
            check(not launch["smem_slices"],
                  "Np 100352 with i32 caps kept its slices in shared memory")
    check(variants == {True, False},
          "K1's shared- and global-memory slice variants were not both run")
    dense_cases = [
        ("random, limit at the pad", dense_problem(rng, tiers=2)),
        ("tied", dense_problem(rng, tied=True)),
        ("negative_free", dense_problem(rng, negative=True)),
    ]
    placing = None
    for name, (k4, k5) in dense_cases:
        args = [torch.from_numpy(a).to(dev) for a in k4]
        placing = placing or args
        got = tk.solve_placement(*args)
        want = tk.solve_placement_plain(*args)
        torch.cuda.synchronize()
        for label, g_, w_ in zip(("assign", "used'"), got, want):
            check(torch.equal(g_, w_), f"dense {name}: {label} differs")
        check(int(got[0].sum()) > 0, f"dense {name}: placed nothing")
        args = [torch.from_numpy(a).to(dev) for a in k5]
        got = tk.solve_placement_preempt(*args)
        want = tk.solve_placement_preempt_plain(*args)
        torch.cuda.synchronize()
        for label, g_, w_ in zip(("assign", "evict", "used'"), got, want):
            check(torch.equal(g_, w_), f"preempt {name}: {label} differs")
        check(int(got[1].sum()) > 0, f"preempt {name}: evicted nothing")
    used, idx, rows = (torch.from_numpy(a).to(dev)
                       for a in scatter_problem(rng))
    for donate in (True, False):
        base = used.clone()
        got = tk.scatter_rows(base, idx, rows.abs(), donate)
        want = tk.scatter_rows_plain(used.clone(), idx, rows.abs(), donate)
        check(torch.equal(got, want), f"scatter_rows donate={donate} differs")
        check((got is base) == donate, "scatter_rows donation")
    got = tk.scatter_add_rows(used, idx, rows)
    want = tk.scatter_add_rows_plain(used, idx, rows)
    check(torch.equal(got, want), "scatter_add_rows differs")
    check(bool((got == 0).any()), "scatter_add_rows: clamp not exercised")
    torch.cuda.synchronize()
    mesh_kernel_checks(dev, rng)
    preempt_edge_checks(dev, rng)
    dense_edge_checks(dev, rng)
    scatter_add_checks(dev, rng)
    scatter_set_checks(dev, rng)
    return placing


def mesh_kernel_checks(dev, rng) -> None:
    """K6 in its three modes at c2m_sharded's bucket (Np 100352, Gp 16)
    on 1 and 8 shards (and 32 on the random problem), and K7 at the preempt wave's bucket (Np 10240,
    Gp 80, Tp 4) on 8 shards: each against its twin, and against the
    single-card kernel (K4 for K6's full and top-k modes, K1 for
    compact, K5 for K7) on the same inputs, array-equal."""
    for name in ("random", "tied", "negative_free"):
        arrays = mesh_problem(rng, tied=name == "tied",
                              negative=name == "negative_free")
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        maxc = tk.pad_c(int(arrays[3].max()))
        idx = torch.arange(t[2].shape[0], dtype=torch.int32, device=dev)
        packed = torch.from_numpy(np.packbits(arrays[4], axis=1)).to(dev)
        single = {
            "full": tk.solve_placement(*t),
            "compact": tk.solve_placement_compact(
                t[0], t[1], t[2], t[3], packed, idx, t[5], idx, t[6], idx,
                max_count=maxc,
            ),
        }
        single["topk"] = single["full"]
        # 32 shards: more lists than the candidate fill merges at once
        for d in ((1, 8, 32) if name == "random" else (1, 8)):
            for mode, kw in (("full", {}), ("topk", {"max_count": maxc}),
                             ("compact", {"max_count": maxc,
                                          "compact": True})):
                got = tk.sharded_solver(*t, n_shards=d, **kw)
                want = tk.sharded_solver_plain(*t, n_shards=d, **kw)
                torch.cuda.synchronize()
                for i, (g_, w_, s_) in enumerate(
                        zip(got, want, single[mode])):
                    check(torch.equal(g_, w_),
                          f"sharded {mode} d{d} {name}: output {i} differs "
                          "from its twin")
                    check(torch.equal(g_, s_),
                          f"sharded {mode} d{d} {name}: output {i} differs "
                          "from the single-card kernel")
        check(int((single["compact"][0] >= 0).sum()) > 0,
              f"sharded {name}: placed nothing")
    # the selection's own edges: unit caps of 1, so a shard's list needs
    # several rounds (counts past 16 x 32), and lists cut by k = 64
    for name, maxc in (("multi_round", 512), ("cut_by_k", 64)):
        arrays = mesh_problem(rng)
        arrays[6] = np.ones_like(arrays[6])
        arrays[3] = rng.integers(300, 501, arrays[3].shape).astype(np.int32)
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        idx = torch.arange(t[2].shape[0], dtype=torch.int32, device=dev)
        packed = torch.from_numpy(np.packbits(arrays[4], axis=1)).to(dev)
        single = {"topk": tk.solve_placement(*t),
                  "compact": tk.solve_placement_compact(
                      t[0], t[1], t[2], t[3], packed, idx, t[5], idx, t[6],
                      idx, max_count=maxc)}
        for d in (1, 8):
            for mode, kw in (("topk", {"max_count": maxc}),
                             ("compact", {"max_count": maxc,
                                          "compact": True})):
                got = tk.sharded_solver(*t, n_shards=d, **kw)
                want = tk.sharded_solver_plain(*t, n_shards=d, **kw)
                torch.cuda.synchronize()
                for i, (g_, w_, s_) in enumerate(
                        zip(got, want, single[mode])):
                    check(torch.equal(g_, w_),
                          f"sharded {mode} d{d} {name}: output {i} differs "
                          "from its twin")
                    # k bounds every group's receivers only uncut
                    if name == "multi_round":
                        check(torch.equal(g_, s_),
                              f"sharded {mode} d{d} {name}: output {i} "
                              "differs from the single-card kernel")
    for name, kwargs in (("random", {}), ("tied", {"tied": True}),
                         ("negative_free", {"negative": True})):
        _, k5 = dense_problem(rng, **kwargs)
        t = [torch.from_numpy(a).to(dev) for a in k5]
        got = tk.sharded_solver_preempt(*t, n_shards=8)
        want = tk.sharded_solver_preempt_plain(*t, n_shards=8)
        single = tk.solve_placement_preempt(*t)
        torch.cuda.synchronize()
        for i, (g_, w_, s_) in enumerate(zip(got, want, single)):
            check(torch.equal(g_, w_),
                  f"sharded preempt {name}: output {i} differs from its twin")
            check(torch.equal(g_, s_),
                  f"sharded preempt {name}: output {i} differs from K5")
        check(int(got[1].sum()) > 0, f"sharded preempt {name}: evicted nothing")


def c2m_nodes(n_nodes: int) -> list:
    """bench.py build_cluster's fleet: 4000 MHz / 8192 MB in dc1-dc4."""
    nodes = []
    for i in range(n_nodes):
        n = mock.node()
        n.datacenter = DCS[i % 4]
        n.resources.cpu = 4000
        n.resources.memory_mb = 8192
        n.computed_class = compute_node_class(n)
        nodes.append(n)
    return nodes


def build_c2m(n_nodes: int, harness=Harness):
    h = harness()
    for n in c2m_nodes(n_nodes):
        h.state.upsert_node(h.next_index(), n)
    return h


def make_job(job_id: str, count: int, *, cpu: int = 250, mem: int = 128,
             priority: int = 50, dcs=DCS, constrained: bool = True):
    """bench.py add_jobs' job: 250 MHz / 128 MB per alloc unless told
    otherwise; constrained adds the kernel.name constraint and the
    datacenter spread (weight 50)."""
    job = mock.job(id=job_id)
    job.datacenters = list(dcs)
    job.priority = priority
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = mem
    tg.tasks[0].resources.networks = []
    if constrained:
        job.constraints.append(
            Constraint("${attr.kernel.name}", "linux", "=")
        )
        job.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
    return job


def add_jobs(h, prefix: str, n_jobs: int, count: int, **kw) -> list:
    """make_job's jobs, upserted into the harness's store."""
    jobs = []
    for j in range(n_jobs):
        job = make_job(f"{prefix}-{j}", count, **kw)
        h.state.upsert_job(h.next_index(), job)
        jobs.append(h.state.job_by_id(job.namespace, job.id))
    return jobs


def rolled(job, count: int):
    """The job scaled to `count` while rolling out a new task version, so
    its eval both stops allocs and places: its stops become the batch's
    usage deltas."""
    job = job.copy()
    job.task_groups[0].count = count
    job.task_groups[0].tasks[0].env = {"FOO": "bar", "VERSION": "2"}
    return job


def scale_down(h, job, count: int):
    job = rolled(job, count)
    h.state.upsert_job(h.next_index(), job)
    return h.state.job_by_id(job.namespace, job.id)


def placements(plans, evals) -> dict:
    out = {}
    for ev in evals:
        plan = plans[ev.id]
        for allocs in plan.node_allocation.values():
            for a in allocs:
                out[(a.job_id, a.name)] = a.node_id
        for b in plan.alloc_batches:
            for a in b.materialize():
                out[(a.job_id, a.name)] = a.node_id
    return out


def commit(h, plans, evals) -> None:
    t0 = time.monotonic_ns()
    for ev in evals:
        h.submit_plan(plans[ev.id])
    trace.stage("commit", time.monotonic_ns() - t0)


def stage_ms(ctx) -> dict:
    """Milliseconds per stage name over one trace (summed)."""
    out: dict = {}
    for span in ctx.spans[1:]:
        out[span.name] = out.get(span.name, 0.0) + span.duration_ns / 1e6
    return out


def three_waves(device: str, n_nodes: int, n_jobs: int, count: int,
                new_jobs: int, on_wave=None, mesh: int = 0) -> dict:
    """The slice's main path: wave 1 (full upload), wave 2 (delta sync +
    adjusted view, left uncommitted), wave 3 (chained on wave 2). Each
    wave runs under a trace, so the solver's own stage timers (reconcile,
    host_prep, device.wait, readback, materialize, plan.assemble) and the
    commit add up to where its time went. mesh > 0 runs the waves on a
    mesh of that many shards."""
    h = build_c2m(n_nodes)
    w1 = add_jobs(h, "w1", n_jobs, count)
    cfg = SchedulerConfig(small_batch_threshold=0, device=device,
                          mesh_devices=mesh)
    resident = gpu.ResidentClusterState(
        mesh=gpu.solver_mesh(mesh, device) if mesh else None, device=device,
    )
    out = {"h": h, "resident": resident, "syncs": [], "evals": [],
           "chains": []}

    t0 = time.perf_counter()
    ctx = trace.TraceContext("wave1")
    with trace.use(ctx):
        ev1 = [mock.eval_for_job(j) for j in w1]
        p1 = gpu.solve_eval_batch(h.snapshot(), h, ev1, cfg,
                                  resident=resident)
        out["syncs"].append(resident.last_sync)
        commit(h, p1, ev1)
    out["evals"].append((ev1, p1))
    if on_wave:
        on_wave("wave1", t0, stages_ms=stage_ms(ctx))

    t0 = time.perf_counter()
    ctx = trace.TraceContext("waves2_3")
    with trace.use(ctx):
        w2 = add_jobs(h, "w2", new_jobs, count)
        w2.append(scale_down(h, w1[0], count // 2))
        ev2 = [mock.eval_for_job(j) for j in w2]
        pend2 = gpu.solve_eval_batch_begin(h.snapshot(), h, ev2, cfg,
                                           resident=resident)
        out["syncs"].append(resident.last_sync)
        out["chains"].append(pend2.chain)

        w3 = add_jobs(h, "w3", new_jobs, count)
        w3.append(scale_down(h, w1[1], count // 2))
        ev3 = [mock.eval_for_job(j) for j in w3]
        pend3 = gpu.solve_eval_batch_begin(h.snapshot(), h, ev3, cfg,
                                           resident=resident,
                                           used_chain=pend2.chain)
        out["syncs"].append(resident.last_sync)
        out["chain_accepted"] = pend3.chain_accepted
        out["chains"].append(pend3.chain)
        for evs, pend in ((ev2, pend2), (ev3, pend3)):
            plans = pend.finish()
            commit(h, plans, evs)
            out["evals"].append((evs, plans))
    if on_wave:
        on_wave("waves2_3", t0, stages_ms=stage_ms(ctx))
    out["placed"] = {}
    for evs, plans in out["evals"]:
        out["placed"].update(placements(plans, evs))
    # node ids are fresh uuids per cluster: compare runs by node position
    pos = {node.id: i for i, node in enumerate(h.state.nodes())}
    out["placed_pos"] = {k: pos[v] for k, v in out["placed"].items()}
    return out


def check_main(res, n_jobs: int, count: int, new_jobs: int) -> None:
    h = res["h"]
    for evs, plans in res["evals"]:
        for ev in evs:
            check(ev.id in plans, "a plan did not come back")
            check(not ev.failed_tg_allocs,
                  f"eval {ev.job_id} failed to place: {ev.failed_tg_allocs}")
    want_live = n_jobs * count - 2 * (count - count // 2) + 2 * new_jobs * count
    live = [a for a in h.state.allocs() if not a.terminal_status()]
    check(len(live) == want_live, f"{len(live)} live allocs, want {want_live}")
    for node in h.state.nodes():
        u = h.state.node_usage(node.id)
        cap = node.available_resources()
        check(u[0] <= cap.cpu and u[1] <= cap.memory_mb,
              f"node {node.id} over capacity: {u} > {cap}")
    syncs = res["syncs"]
    check(syncs[0] == "full", f"wave 1 sync {syncs[0]}")
    check(syncs[1].startswith("delta:"), f"wave 2 sync {syncs[1]}")
    check(res["chain_accepted"], "wave 3 did not accept the chain")


# ---------------------------------------------------------------------------
# the preemption route (BASELINE config 4 at c2m scale)
# ---------------------------------------------------------------------------

DC123 = DCS[:3]
# (job prefix, jobs, allocs per job, priority, datacenters), highest tier
# first so that no fill batch can preempt: 90,000 allocs, 90% of the
# 100,000 slots of 10,000 nodes at 400 MHz / 800 MB
C2M_FILLS = [
    ("p65", 25, 900, 65, ["dc4"]),
    ("p40", 30, 900, 40, DC123),
    ("p20", 45, 900, 20, DC123),
]
# bench.py run_preempt_config: 500 nodes, 25 x 180 at priority 20
BENCH_FILLS = [("fill", 25, 180, 20, DCS)]


def preempt_outcome(h, plans, evals) -> dict:
    """What a wave decided, by node position and (job id, alloc name),
    read from its plans after the commit (the store keeps the evicted
    allocs it names)."""
    pos = {node.id: i for i, node in enumerate(h.state.nodes())}

    def key(alloc_id):
        a = h.state.alloc_by_id(alloc_id)
        return (a.job_id, a.name)

    placed, by, victims, prios, unplaced = {}, {}, [], set(), 0
    for ev in evals:
        plan = plans[ev.id]
        for allocs in plan.node_allocation.values():
            for a in allocs:
                placed[(a.job_id, a.name)] = pos[a.node_id]
                if a.preempted_allocations:
                    by[(a.job_id, a.name)] = sorted(
                        key(v) for v in a.preempted_allocations
                    )
        for b in plan.alloc_batches:
            for a in b.materialize():
                placed[(a.job_id, a.name)] = pos[a.node_id]
        for allocs in plan.node_preemptions.values():
            for v in allocs:
                victims.append((v.job_id, v.name, pos[v.node_id]))
                prios.add(h.state.job_by_id(v.namespace, v.job_id).priority)
        unplaced += sum(m.coalesced_failures + 1
                        for m in ev.failed_tg_allocs.values())
    return {"placed": placed, "preempted_by": by, "victims": sorted(victims),
            "unplaced": unplaced, "victim_prios": sorted(prios)}


def preempt_fleet(device: str, n_nodes: int, fills: list, wave: tuple):
    """The fleet filled through the compact route, and the priority-70
    wave's jobs (jobs, allocs per job, constrained) at 400 MHz / 800 MB,
    added but not yet solved."""
    h = build_c2m(n_nodes)
    fill_cfg = SchedulerConfig(small_batch_threshold=0, device=device)
    for prefix, n_jobs, count, prio, dcs in fills:
        jobs = add_jobs(h, prefix, n_jobs, count, cpu=400, mem=800,
                        priority=prio, dcs=dcs, constrained=False)
        evs = [mock.eval_for_job(j) for j in jobs]
        plans = gpu.solve_eval_batch(h.snapshot(), h, evs, fill_cfg)
        commit(h, plans, evs)
    n_jobs, count, constrained = wave
    jobs = add_jobs(h, "hi", n_jobs, count, cpu=400, mem=800, priority=70,
                    constrained=constrained)
    return h, jobs


def preempt_scenario(device: str, n_nodes: int, fills: list, wave: tuple,
                     before_wave=None, on_wave=None, mesh: int = 0) -> dict:
    """Fill the fleet, then solve one priority-70 wave in one batch with
    preemption on (on a mesh of `mesh` shards when mesh > 0), and commit
    it. The wave runs under a trace, so its stage spans and the commit
    add up to where its time went; reading its outcome comes after its
    timer stops."""
    h, jobs = preempt_fleet(device, n_nodes, fills, wave)
    evs = [mock.eval_for_job(j) for j in jobs]
    cfg = SchedulerConfig(preemption_service=True, small_batch_threshold=0,
                          device=device, mesh_devices=mesh)
    if before_wave:
        before_wave()
    t0 = time.perf_counter()
    ctx = trace.TraceContext("preempt")
    with trace.use(ctx):
        plans = gpu.solve_eval_batch(h.snapshot(), h, evs, cfg)
        commit(h, plans, evs)
    if on_wave:
        on_wave("preempt.wave", t0, stages_ms=stage_ms(ctx))
    out = preempt_outcome(h, plans, evs)
    out["h"] = h
    return out


def check_preempt(res, wave_allocs: int, kept: dict) -> None:
    """After the commit: every node's live allocs fit its capacity,
    every victim sat at least PRIORITY_DELTA below the wave, the tiers
    in `kept` ({priority: live allocs}) lost nothing, each victim is
    charged to exactly one placement, and every alloc of the wave was
    either placed or reported unplaced."""
    h = res["h"]
    for node in h.state.nodes():
        u = h.state.node_usage(node.id)
        cap = node.available_resources()
        check(u[0] <= cap.cpu and u[1] <= cap.memory_mb,
              f"node {node.id} over capacity: {u} > {cap}")
    check(all(p <= 60 for p in res["victim_prios"]),
          f"victims at priorities {res['victim_prios']}")
    live: dict = {}
    for a in h.state.allocs():
        if not a.terminal_status():
            p = h.state.job_by_id(a.namespace, a.job_id).priority
            live[p] = live.get(p, 0) + 1
    for prio, n in kept.items():
        check(live.get(prio, 0) == n,
              f"priority {prio}: {live.get(prio, 0)} live, want {n}")
    charged = sum(len(v) for v in res["preempted_by"].values())
    check(charged == len(res["victims"]),
          f"{charged} victims charged to placements, "
          f"{len(res['victims'])} in the plans")
    total = len(res["placed"]) + res["unplaced"]
    check(total == wave_allocs,
          f"placed {len(res['placed'])} + unplaced {res['unplaced']} "
          f"!= {wave_allocs}")
    check(live.get(70, 0) == len(res["placed"]),
          "a placement of the wave was not committed")


# ---------------------------------------------------------------------------
# the per-eval schedulers under node-drain churn (BASELINE config 5, and
# config 5 with an overlapping rollout)
# ---------------------------------------------------------------------------


class TimedHarness(Harness):
    """The harness whose plan commits run under trace.stage("commit")."""

    def submit_plan(self, plan):
        t0 = time.monotonic_ns()
        out = super().submit_plan(plan)
        trace.stage("commit", time.monotonic_ns() - t0)
        return out


def system_jobs(h, kinds) -> list:
    """bench.py run_drain_config's system job (100 MHz / 64 MB, no
    networks, dc1-dc4), once per kind ("system", "sysbatch")."""
    out = []
    for kind in kinds:
        make = mock.system_job if kind == "system" else mock.sysbatch_job
        job = make(id=f"drain-{kind}")
        job.datacenters = list(DCS)
        t = job.task_groups[0].tasks[0]
        t.resources.cpu = 100
        t.resources.memory_mb = 64
        t.resources.networks = []
        h.state.upsert_job(h.next_index(), job)
        out.append(h.state.job_by_id(job.namespace, job.id))
    return out


def drain_nodes(h, nodes) -> set:
    """Drain the nodes and mark their live allocs for migration, as
    bench.py run_drain_config's stand-in for the node drainer does."""
    for n in nodes:
        h.state.update_node_drain(h.next_index(), n.id,
                                  DrainStrategy(deadline_s=300))
    drained = {n.id for n in nodes}
    marks = {
        a.id: DesiredTransition(migrate=True)
        for nid in drained
        for a in h.state.allocs_by_node_terminal(nid, False)
    }
    h.state.update_alloc_desired_transition(h.next_index(), marks, [])
    return drained


def drain_scenario(device: str, n_nodes: int, svc_jobs: int, svc_count: int,
                   drain_n: int, *, bench: bool = False, seed: int = 0,
                   on_stage=None) -> dict:
    """Node-drain churn through the per-eval entry point, one eval at a
    time as a server's workers take them: Harness.process ->
    new_scheduler -> TPUGenericScheduler / TPUSystemScheduler, on
    `device`. The service evals share one ResidentClusterState, so each
    syncs the rows that changed (K2 donated) and an eval's stops on live
    nodes reach the card as an adjusted copy (K2 not donated) before K1.

    The drain phase's form, BASELINE config 5 with an overlapping
    rollout (DRAIN_WORKLOAD): a system and a sysbatch job, then `svc_jobs`
    x `svc_count` service jobs with the constraint and the spread; then
    a seeded sample of `drain_n` nodes drained with migrate marks while
    every service rolls out a new task version (a deploy and a drain
    that overlap: each node-update eval migrates the drained nodes'
    allocs and starts the rolling update, max_parallel 5 destructive
    replacements whose stops sit on live nodes; a drain alone stops
    allocs only on drained nodes, outside the eval's node universe, and
    sends no adjusted copy to the card); every affected eval; then the
    host oracle's routes (drain_host_routes).

    With `bench`, BASELINE config 5 as bench.py run_drain_config
    defines it: the service jobs
    unconstrained, then one system job, the first `drain_n` nodes
    drained, no roll and no host routes."""
    h = build_c2m(n_nodes, harness=TimedHarness)
    cfg = SchedulerConfig(device=device)
    resident = gpu.ResidentClusterState(device=device)
    rng = random.Random(seed)
    out = {"h": h, "evals": [], "stages": {}}

    def run(kind: str, ev, stage: str) -> None:
        ctx = trace.TraceContext(stage)
        t0 = time.perf_counter()
        with trace.use(ctx):
            extra = {"resident": resident} if kind == "service" else {}
            h.process(kind, ev, cfg, rng=rng, **extra)
        ms = stage_ms(ctx)
        ms["wall"] = 1e3 * (time.perf_counter() - t0)
        out["stages"].setdefault(f"{stage}.{kind}", []).append(ms)
        upd = h.updates[-1]
        check(upd.id == ev.id and upd.status == "complete",
              f"{stage} eval of {ev.job_id}: {upd.status} "
              f"{upd.status_description}")
        out["evals"].append(upd)

    def register_systems():
        out["systems"] = system_jobs(
            h, ("system",) if bench else ("system", "sysbatch"))
        for job in out["systems"]:
            run(job.type, mock.eval_for_job(job), "register")

    if not bench:
        register_systems()
    svcs = add_jobs(h, "svc", svc_jobs, svc_count, constrained=not bench)
    for job in svcs:
        run("service", mock.eval_for_job(job), "register")
    if bench:
        register_systems()
    if on_stage:
        on_stage("register")
    if not bench:
        for k, job in enumerate(svcs):
            job = job.copy()
            job.task_groups[0].tasks[0].env = {"FOO": "bar", "VERSION": "2"}
            h.state.upsert_job(h.next_index(), job)
            svcs[k] = h.state.job_by_id(job.namespace, job.id)
    nodes = h.state.nodes()
    out["drained"] = drain_nodes(
        h, nodes[:drain_n] if bench
        else random.Random(seed + 1).sample(nodes, drain_n))
    for job in svcs:
        if any(a.node_id in out["drained"]
               for a in h.state.allocs_by_job(job.namespace, job.id)
               if not a.terminal_status()):
            run("service", mock.eval_for_job(job, triggered_by="node-update"),
                "drain")
    for job in out["systems"]:
        run(job.type, mock.eval_for_job(job, triggered_by="node-update"),
            "drain")
    if on_stage:
        on_stage("drain")
    out["svcs"] = svcs
    if not bench:
        out["routes"] = drain_host_routes(h, cfg, rng, run)
        if on_stage:
            on_stage("host_routes")
    # node ids are fresh uuids per cluster: compare runs by node position
    pos = {node.id: i for i, node in enumerate(h.state.nodes())}
    out["placed_pos"] = {
        (a.job_id, a.name): pos[a.node_id]
        for a in h.state.allocs() if not a.terminal_status()
    }
    return out


def drain_host_routes(h, cfg, rng, run) -> dict:
    """The host oracle's routes on the drained fleet: a 40-alloc job with
    a sticky ephemeral disk replaced by a destructive update (its asks
    prefer their previous nodes), a 100-alloc job whose 60 failed allocs
    reschedule at once with a penalty on their nodes, and one pending
    batch re-solved by solve_host_fallback."""
    (sticky,) = add_jobs(h, "sticky", 1, 40, constrained=False)
    sticky = sticky.copy()
    sticky.update = None
    tg = sticky.task_groups[0]
    tg.update = None
    tg.ephemeral_disk.sticky = True
    h.state.upsert_job(h.next_index(), sticky)
    sticky = h.state.job_by_id(sticky.namespace, sticky.id)
    run("service", mock.eval_for_job(sticky), "routes")
    before = {a.name: a.node_id for a in live_allocs(h, sticky)}
    v1 = sticky.copy()
    v1.task_groups[0].tasks[0].env = {"FOO": "bar", "VERSION": "2"}
    h.state.upsert_job(h.next_index(), v1)
    v1 = h.state.job_by_id(v1.namespace, v1.id)
    with HostSolves() as host:
        run("service", mock.eval_for_job(v1), "routes")
    after = {a.name: a.node_id for a in live_allocs(h, v1)}
    check(len(before) == 40 and after == before,
          "a sticky replacement left its previous node")
    check(all(a.job.version == v1.version for a in live_allocs(h, v1)),
          "a sticky alloc was not replaced")
    check(host.n > 0, "the sticky asks did not take the host")

    (resched,) = add_jobs(h, "resched", 1, 100, constrained=False)
    resched = resched.copy()
    resched.task_groups[0].reschedule_policy.delay_s = 0
    h.state.upsert_job(h.next_index(), resched)
    resched = h.state.job_by_id(resched.namespace, resched.id)
    run("service", mock.eval_for_job(resched), "routes")
    failed = []
    for a in live_allocs(h, resched)[:60]:
        f = a.copy()
        f.client_status = ALLOC_CLIENT_STATUS_FAILED
        f.task_states = {}
        failed.append(f)
    h.state.update_allocs_from_client(h.next_index(), failed)
    with HostSolves() as host:
        run("service",
            mock.eval_for_job(resched, triggered_by="alloc-failure"),
            "routes")
    penalty = {a.name: a.node_id for a in failed}
    repl = [a for a in live_allocs(h, resched) if a.name in penalty]
    check(len(repl) == 60, f"{len(repl)} of 60 failed allocs rescheduled")
    check(all(a.node_id != penalty[a.name] for a in repl),
          "a rescheduled alloc landed on its penalty node")
    check(host.n > 0, "the penalty asks did not take the host")

    (fb,) = add_jobs(h, "fallback", 1, 200, constrained=False)
    ev = mock.eval_for_job(fb)
    pend = gpu.solve_eval_batch_begin(h.snapshot(), h, [ev], cfg, rng=rng)
    plans = pend.solve_host_fallback()
    check(pend.chain is None, "the host fallback exposed a chain")
    h.submit_plan(plans[ev.id])
    check(not ev.failed_tg_allocs and len(live_allocs(h, fb)) == 200,
          "the host fallback did not place its batch")
    return {"sticky": len(after), "rescheduled": len(repl),
            "fallback_placed": 200}


def live_allocs(h, job) -> list:
    return [a for a in h.state.allocs_by_job(job.namespace, job.id)
            if not a.terminal_status()]


class HostSolves:
    """Counts the batch solver's host-stack solves (_solve_host) while
    installed."""

    def __init__(self) -> None:
        self.n = 0
        self.real = solver_mod.BatchSolver._solve_host

    def __enter__(self):
        real = self.real

        def counted(solver, asks):
            self.n += 1
            return real(solver, asks)

        solver_mod.BatchSolver._solve_host = counted
        return self

    def __exit__(self, *exc) -> None:
        solver_mod.BatchSolver._solve_host = self.real


def check_drain(res, svc_jobs: int, svc_count: int) -> None:
    """Every service alloc placed and none left on a drained node, every
    system and sysbatch alloc on every undrained node, no node over
    capacity, every eval complete with nothing failed."""
    h, drained = res["h"], res["drained"]
    for ev in res["evals"]:
        check(not ev.failed_tg_allocs,
              f"eval of {ev.job_id} failed to place: {ev.failed_tg_allocs}")
    live = [a for a in h.state.allocs() if not a.terminal_status()]
    check(not any(a.node_id in drained for a in live),
          "a live alloc is left on a drained node")
    for job in res["svcs"]:
        n = len(live_allocs(h, job))
        check(n == svc_count, f"{job.id}: {n} live, want {svc_count}")
    undrained = len(h.state.nodes()) - len(drained)
    for job in res["systems"]:
        n = len(live_allocs(h, job))
        check(n == undrained, f"{job.id}: {n} live, want {undrained}")
    for node in h.state.nodes():
        u = h.state.node_usage(node.id)
        cap = node.available_resources()
        check(u[0] <= cap.cpu and u[1] <= cap.memory_mb,
              f"node {node.id} over capacity: {u} > {cap}")


def stage_summary(stages: dict) -> dict:
    """Per eval group: evals, and each stage's median and sum (ms)."""
    out = {}
    for group, evals in stages.items():
        names = sorted({k for ms in evals for k in ms})
        out[group] = {"evals": len(evals)}
        for k in names:
            vals = [ms.get(k, 0.0) for ms in evals]
            out[group][k] = {"median": statistics.median(vals),
                             "sum": sum(vals)}
    return out


# ---------------------------------------------------------------------------
# the server's scheduling pipeline at c2m's width: Server.job_register ->
# FSM -> EvalBroker -> TPUBatchWorker (phase A on its solve thread, phase B
# on its commit thread) -> PlanQueue -> PlanApplier -> FSM -> ack
# ---------------------------------------------------------------------------

# bench.py run_pipeline_config's drain bound (BENCH_PIPE_BATCH)
SERVER_BATCH = 8
# the roll wave after c2m's 100 jobs: 20 new jobs, and 4 of wave 1's jobs
# scaled 1,000 -> 500 while rolling a new task version, registered at
# these positions of the 24 (past the first batch, so each rides a batch
# that may chain on the one in flight: a chained batch's stops are what
# K3 adds onto the chained used' tensor)
SERVER_ROLL_NEW, SERVER_ROLL_AT = 20, (10, 14, 18, 22)
# the spans a batch trace sums (trace.finished_traces): the solve stage,
# the commit stage, the applier's verify and raft apply under the plan
# submit, the FSM apply under it and, under that, the event stream's
# publish of the store's writes
SERVER_SPANS = (
    "broker.drain", "snapshot.wait", "solve.dispatch", "reconcile", "sync",
    "node_table", "lower", "host_prep", "commit.handoff", "commit.finish",
    "device.wait", "readback", "materialize", "plan.assemble",
    "plan.submit", "plan.verify", "plan.raft_apply", "fsm.apply",
    "events.publish", "eval.ack",
)


def start_server(device: str, nodes: list, pipeline: bool = True,
                 leader: bool = True, **cfg):
    """The port's Server with the GPU batch worker (batches of
    SERVER_BATCH; `cfg` goes to its SchedulerConfig) and the fleet
    registered through raft in chunks of 1,000 nodes. leader=False
    enables the broker, the plan queue and the applier but starts no
    worker, for a caller that drives the batch worker by hand. Returns
    (server, seconds establish_leadership took)."""
    from nomad_tpu_torch.server import Server

    srv = Server(use_tpu_batch_worker=True,
                 scheduler_config=SchedulerConfig(device=device, **cfg))
    srv.tpu_worker.batch_size = SERVER_BATCH
    srv.tpu_worker.pipeline = pipeline
    t0 = time.perf_counter()
    if leader:
        srv.establish_leadership()
    else:
        srv.eval_broker.set_enabled(True)
        srv.plan_queue.set_enabled(True)
        srv.blocked_evals.set_enabled(True)
        srv.plan_applier.start()
        srv._leader = True  # the FSM side channels enqueue evals
    lead_s = time.perf_counter() - t0
    for i in range(0, len(nodes), 1000):
        srv.raft_apply("node_register_batch", nodes[i:i + 1000])
    return srv, lead_s


def live_rows(state) -> list:
    """Every non-terminal alloc row in the store, lazy SoA handles left
    unmaterialized."""
    from nomad_tpu_torch.state.store import TABLE_ALLOCS

    return [a for a in state._tables[TABLE_ALLOCS].values()
            if not a.terminal_status()]


def register_and_wait(srv, jobs: list, timeout_s: float = 900.0) -> float:
    """Seconds from the first Server.job_register to the moment every
    registered eval is complete (its last batch committed and acked). A
    nacked eval — a batch whose chained parent committed only in part —
    redelivers after the broker's nack delay, so wait_for_evals alone
    (which sees no delayed eval) is not enough."""
    t0 = time.perf_counter()
    ids = [srv.job_register(job) for job in jobs]
    deadline = t0 + timeout_s
    while True:
        check(srv.wait_for_evals(max(0.0, deadline - time.perf_counter())),
              f"evals still in flight after {timeout_s} s")
        if all(srv.state.eval_by_id(i).status == "complete" for i in ids):
            return time.perf_counter() - t0
        check(time.perf_counter() < deadline,
              f"evals not complete after {timeout_s} s")
        time.sleep(0.05)


def batch_traces() -> list:
    return [t for t in trace.finished_traces() if t.name == "tpu.batch"]


def span_sums_ms(traces: list, names=SERVER_SPANS) -> dict:
    out = {name: 0.0 for name in names}
    for t in traces:
        for span in t.spans[1:]:
            if span.name in out:
                out[span.name] += span.duration_ns / 1e6
    return {k: v for k, v in out.items() if v}


def check_server_state(srv, want_live: int) -> None:
    """want_live live allocs, no node over capacity, every eval
    complete."""
    state = srv.state
    live = live_rows(state)
    check(len(live) == want_live, f"{len(live)} live allocs, want {want_live}")
    for node in state.nodes():
        u = state.node_usage(node.id)
        cap = node.available_resources()
        check(u[0] <= cap.cpu and u[1] <= cap.memory_mb,
              f"node {node.id} over capacity: {u} > {cap}")
    bad = [(e.job_id, e.status) for e in state.evals()
           if e.status != "complete"]
    check(not bad, f"evals not complete: {bad[:5]}")


def wave_numbers(before: dict, after: dict, traces: list, wall: float,
                 n_jobs: int, n_allocs: int) -> dict:
    """One wave's numbers from two metrics snapshots around it and its
    finished batch traces: wall, rates, batch counts and summed spans."""
    def count(name):
        return (after["counters"].get(name, 0)
                - before["counters"].get(name, 0))

    def hist_sum(name):
        return (after["samples"].get(name, {}).get("sum", 0.0)
                - before["samples"].get(name, {}).get("sum", 0.0))

    return {
        "wall_s": wall, "jobs_per_s": n_jobs / wall,
        "allocs_per_s": n_allocs / wall, "batches": len(traces),
        "compact_batches": sum(
            1 for t in traces
            if any(sp.name == "device.wait" for sp in t.spans)),
        "chained_batches": count("nomad.tpu.chained_batches"),
        "partial_commits": count("nomad.tpu.partial_commits"),
        "chain_parent_failed": count("nomad.tpu.chain_parent_failed"),
        "device_failover": count("nomad.worker.device_failover"),
        "invoke_failed": count("nomad.worker.invoke.failed"),
        "phase_a_ms": 1e3 * hist_sum("nomad.tpu.batch_dispatch_seconds"),
        "spans_ms": span_sums_ms(traces),
    }


def server_scenario(device: str, n_nodes: int, n_jobs: int, count: int,
                    on_phase) -> dict:
    """c2m's fleet and 100 jobs through the Server's entry points, then
    the roll wave, on one Server with the pipelined worker; launch
    counters zeroed just before the first job_register and read after
    the roll wave. Returns the server (left running for the failover and
    system phases), the counts and the numbers to print."""
    from nomad_tpu_torch import codec, metrics
    from nomad_tpu_torch.metrics import Registry

    metrics._install_registry(Registry())
    trace.clear_finished()
    srv, lead_s = start_server(device, c2m_nodes(n_nodes))
    w = srv.tpu_worker
    tk.reset_launch_counts()
    m0 = metrics.snapshot()
    jobs = [make_job(f"srv-{j}", count) for j in range(n_jobs)]
    wall1 = register_and_wait(srv, jobs)
    check_server_state(srv, n_jobs * count)
    m1 = metrics.snapshot()
    c2m = wave_numbers(m0, m1, batch_traces(), wall1, n_jobs,
                       n_jobs * count)
    on_phase("server.c2m", wall1, **c2m)
    trace.clear_finished()

    roll = [make_job(f"srv-roll-{j}", count) for j in range(SERVER_ROLL_NEW)]
    for k, at in enumerate(SERVER_ROLL_AT):
        stored = srv.state.job_by_id(jobs[k].namespace, jobs[k].id)
        roll.insert(at, rolled(stored, count // 2))
    wall2 = register_and_wait(srv, roll)
    want_live = (n_jobs * count - len(SERVER_ROLL_AT) * (count - count // 2)
                 + SERVER_ROLL_NEW * count)
    check_server_state(srv, want_live)
    launches = launch_counts()
    m2 = metrics.snapshot()
    rollw = wave_numbers(m1, m2, batch_traces(), wall2, len(roll),
                         SERVER_ROLL_NEW * count
                         + len(SERVER_ROLL_AT) * (count // 2))
    on_phase("server.roll", wall2, **rollw)
    whole = wave_numbers(m0, m2, [], wall1 + wall2, 0, 0)
    return {
        "srv": srv, "launches": launches, "counters": m2["counters"],
        "live": want_live, "c2m": c2m, "roll": rollw,
        "compact_batches": c2m["compact_batches"]
        + rollw["compact_batches"],
        "chained_batches": whole["chained_batches"],
        "numbers": {
            "wall_s": wall1, "roll_wall_s": wall2,
            "establish_leadership_s": lead_s,
            "build_s": dict(w.warm_seconds),
            "fastpack_live": codec.native_module() is not None,
        },
    }


def check_server(res) -> None:
    srv, c = res["srv"], res["counters"]
    w = srv.tpu_worker
    from nomad_tpu_torch import codec

    check(c.get("nomad.worker.device_failover", 0) == 0,
          "a device failover in a phase that injects nothing")
    check(c.get("nomad.worker.invoke.failed", 0) == 0,
          "a batch failed to solve or commit")
    cuda0 = torch.device("cuda", 0)
    r = w._resident
    check(r is not None and r._cap_dev.device == cuda0
          and r._used_dev.device == cuda0,
          "the worker's resident tensors are not on cuda:0")
    check(not w.mesh_degraded, "the worker degraded its mesh")
    check(codec.native_module() is not None, "the C fastpack did not load")
    k1 = res["launches"]["solve_placement_compact"]
    check(res["compact_batches"] > 0 and k1 >= res["compact_batches"],
          f"K1 ran {k1} times for {res['compact_batches']} compact batches")
    check(res["launches"]["scatter_add_rows"] >= 1,
          "K3 was not launched: no batch chained with stops")
    check(res["chained_batches"] >= 1, "no batch chained")


# server.overlap's depth: the first 40 of c2m's 100 jobs on each of its
# four fresh servers (100 until the tenancy phase came; the earlier
# overlap ratios in PERF.md are at 100)
SERVER_OVERLAP_JOBS = 40
# pool.c2m's jobs: 50 of c2m's 100 (cut to keep the run's time since the
# fleet, soak and scenario phases came)
POOL_C2M_JOBS = 50


def server_overlap(device: str, n_nodes: int, n_jobs: int,
                   count: int) -> dict:
    """The same fleet and n_jobs c2m jobs on fresh servers, traced, serial
    (pipeline=False: the worker solves and commits each batch before it
    dequeues the next) and pipelined in the order serial, pipelined,
    pipelined, serial, so a drift over the four runs falls on both.
    Returns each run's numbers and the overlap ratio, the serial walls'
    sum over the pipelined walls' sum (above 1: the overlap wins)."""
    from nomad_tpu_torch import metrics
    from nomad_tpu_torch.metrics import Registry

    runs = []
    trace.set_enabled(True)
    try:
        for pipeline in (False, True, True, False):
            metrics._install_registry(Registry())
            trace.clear_finished()
            srv, _ = start_server(device, c2m_nodes(n_nodes),
                                  pipeline=pipeline)
            try:
                m0 = metrics.snapshot()
                wall = register_and_wait(
                    srv, [make_job(f"srv-{j}", count)
                          for j in range(n_jobs)])
                check_server_state(srv, n_jobs * count)
                n = wave_numbers(m0, metrics.snapshot(), batch_traces(),
                                 wall, n_jobs, n_jobs * count)
            finally:
                srv.shutdown()
            spans = n["spans_ms"]
            runs.append({"pipeline": pipeline, "wall_s": wall,
                         "batches": n["batches"],
                         "phase_a_ms": n["phase_a_ms"],
                         "commit_finish_ms": spans.get("commit.finish"),
                         "plan_submit_ms": spans.get("plan.submit")})
    finally:
        trace.set_enabled(False)
    serial = sum(r["wall_s"] for r in runs if not r["pipeline"])
    piped = sum(r["wall_s"] for r in runs if r["pipeline"])
    return {"runs": runs, "overlap_ratio": serial / piped}


def server_failover(srv, live: int) -> dict:
    """One retriable DeviceFault injected at the commit stage's device
    wait: exactly one device_failover, that batch committed through
    solve_host_fallback, and every alloc placed."""
    from nomad_tpu_torch import faultplane, metrics

    calls = []
    real = gpu.PendingEvalBatch.solve_host_fallback

    def counted(self):
        calls.append(len(self.evals))
        return real(self)

    before = metrics.snapshot()["counters"].get(
        "nomad.worker.device_failover", 0)
    gpu.PendingEvalBatch.solve_host_fallback = counted
    faultplane.install(faultplane.FaultPlane(seed=0)).fail_device(
        "finish", retriable=True, times=1)
    try:
        jobs = [make_job(f"fo-{j}", 50, constrained=False) for j in range(4)]
        wall = register_and_wait(srv, jobs)
    finally:
        faultplane.uninstall()
        gpu.PendingEvalBatch.solve_host_fallback = real
    failovers = metrics.snapshot()["counters"].get(
        "nomad.worker.device_failover", 0) - before
    check(failovers == 1, f"{failovers} device failovers, want exactly 1")
    check(len(calls) == 1, f"solve_host_fallback ran {len(calls)} times")
    check_server_state(srv, live + 4 * 50)
    return {"wall_s": wall, "failovers": failovers,
            "fallback_evals": calls[0]}


def server_system(srv, live: int) -> dict:
    """A system job (100 MHz / 64 MB, bench.py run_drain_config's) on
    every node with room for it, then a new node: the system worker
    places the job on it."""
    job = mock.system_job(id="srv-system")
    job.datacenters = list(DCS)
    tg = job.task_groups[0]
    tg.tasks[0].resources.cpu = 100
    tg.tasks[0].resources.memory_mb = 64
    tg.tasks[0].resources.networks = []
    state = srv.state
    room = 0
    for node in state.nodes():
        u, cap = state.node_usage(node.id), node.available_resources()
        room += cap.cpu - u[0] >= 100 and cap.memory_mb - u[1] >= 64
    wall = register_and_wait(srv, [job])
    placed = sum(1 for a in state.allocs_by_job(job.namespace, job.id)
                 if not a.terminal_status())
    check(placed == room, f"system job on {placed} nodes, {room} have room")
    check_server_state(srv, live + room)
    node = c2m_nodes(1)[0]
    t0 = time.perf_counter()
    srv.node_register(node)
    check(srv.wait_for_evals(120), "the new node's eval is still in flight")
    node_wall = time.perf_counter() - t0
    on_new = [a for a in state.allocs_by_node(node.id)
              if not a.terminal_status()]
    check([a.job_id for a in on_new] == [job.id],
          f"the new node holds {[a.job_id for a in on_new]}")
    check_server_state(srv, live + room + 1)
    return {"wall_s": wall, "node_wall_s": node_wall,
            "system_allocs": room + 1, "nodes": len(state.nodes())}


def server_lockstep(device: str, nodes: list, jobs: list,
                    n_batches: int) -> dict:
    """bench.py run_pipeline_config's shapes, the batch worker driven by
    hand in a fixed order: dequeue and solve batch i+1 while batch i's
    commit is still pending (so i+1 chains on i's used' tensor), then
    commit in FIFO order. Returns the placements by (job, alloc name,
    node) and each batch's (chained, chain accepted, verdict)."""
    import threading

    srv, _ = start_server(device, nodes, leader=False)
    w = srv.tpu_worker
    try:
        for job in jobs:
            srv.job_register(job)
        solved = []
        for _ in range(n_batches):
            batch = []
            while len(batch) < SERVER_BATCH:
                ev, tok = srv.eval_broker.dequeue(["service"], timeout_s=1)
                check(ev is not None, "the broker ran dry")
                batch.append((ev, tok))
            pending, snap, chained_on = w._solve_batch([e for e, _ in batch])
            committed, outcome = threading.Event(), {"ok": None}
            basis = chained_on[1] if chained_on else snap.index
            w._prev = (pending, committed, outcome, basis)
            solved.append((batch, pending, snap, committed, outcome,
                           chained_on))
        verdicts = []
        for batch, pending, snap, committed, outcome, chained_on in solved:
            w._commit(batch, pending, snap, committed, outcome, chained_on)
            verdicts.append((chained_on is not None, pending.chain_accepted,
                             outcome["ok"]))
        placed = sorted(
            (a.job_id, a.name, a.node_id)
            for j in jobs
            for a in srv.state.allocs_by_job(j.namespace, j.id)
            if not a.terminal_status()
        )
    finally:
        srv.shutdown()
    return {"placed": placed, "verdicts": verdicts}


# ---------------------------------------------------------------------------
# the job lifecycle (nomad_tpu's server/{job_plan,deployment_watcher,
# drainer,periodic}.py, ported) at c2m's width, through the Server's own
# endpoints: job plan, canary deployments promoted and rolled, an
# auto-revert, a node drain, and periodic and dispatched jobs
# ---------------------------------------------------------------------------

# c2m's jobs with an update stanza (max_parallel 250, canary 10,
# min_healthy_time 0, healthy_deadline 5m, auto_revert) and a migrate
# stanza (max_parallel 100); 4 of them rolled, job 5 reverted, a seeded
# 10% of the nodes drained, 100-alloc periodic and dispatched children
LIFE = {"jobs": 20, "count": 1000, "canary": 10, "max_parallel": 250,
        "migrate": 100, "roll": 4, "revert": 5, "drain_ratio": 0.1,
        "child": 100}
# the same five steps at 200 nodes, card against CPU twins
LIFE_SMALL = {"jobs": 20, "count": 50, "canary": 2, "max_parallel": 10,
              "migrate": 5, "roll": 4, "revert": 5, "drain_ratio": 0.1,
              "child": 20}
# Health is reported as an operator reports it: Server.alloc_set_health
# for deployments (it mints no eval, as in nomad_tpu, so each rolling
# step after the first is started with Server.job_force_evaluate), and
# Server.update_allocs_from_client (client status running) for a drain's
# replacements. No client runs: no wall below is a client's.
LIFE_HEALTH = ("alloc_set_health (deployments), job_force_evaluate (each "
               "rolling step after the promote), update_allocs_from_client "
               "running (drain replacements); no client")


def lifecycle_job(structs, make, job_id: str, count: int, cfg: dict):
    """make(job_id, count) with the lifecycle's update and migrate
    stanzas."""
    job = make(job_id, count)
    update = structs.UpdateStrategy(
        max_parallel=cfg["max_parallel"], canary=cfg["canary"],
        min_healthy_time_s=0.0, healthy_deadline_s=300.0, auto_revert=True,
    )
    job.update = update
    job.task_groups[0].update = update.copy()
    job.task_groups[0].migrate = structs.MigrateStrategy(
        max_parallel=cfg["migrate"])
    return job


def bumped(job, tag: str):
    """The job with a new task env: a destructive update."""
    job = job.copy()
    job.task_groups[0].tasks[0].env = {"FOO": "bar", "VERSION": tag}
    return job


def child_jobs(structs, make, count: int) -> tuple:
    """A periodic batch job (*/5, prohibit_overlap) and a parameterized
    batch job, each of `count` allocs."""
    per = make("life-periodic", count)
    per.type = "batch"
    per.periodic = structs.PeriodicConfig(
        enabled=True, spec="*/5 * * * *", prohibit_overlap=True)
    par = make("life-dispatch", count)
    par.type = "batch"
    par.parameterized = structs.ParameterizedJobConfig(
        payload="forbidden", meta_optional=["run"])
    return per, par


def latest_dep(state, job):
    return state.latest_deployment_by_job(job.namespace, job.id)


def mark_healthy(srv, job) -> int:
    """alloc_set_health for every live alloc of the job's active
    deployment not yet healthy. Returns how many were marked."""
    d = latest_dep(srv.state, job)
    if d is None or not d.active():
        return 0
    ids = [a.id for a in live_allocs(srv, job)
           if a.deployment_id == d.id
           and not (a.deployment_status is not None
                    and a.deployment_status.is_healthy())]
    if ids:
        srv.alloc_set_health(d.id, ids, [])
    return len(ids)


def report_running(srv, jobs) -> int:
    """update_allocs_from_client(running) for every live alloc of the
    jobs that no client or deployment reported yet (a drain's
    replacements). Returns how many."""
    ups = []
    for job in jobs:
        for a in live_allocs(srv, job):
            if a.client_status == "pending" and a.deployment_status is None:
                c = a.copy()
                c.client_status = "running"
                ups.append(c)
    if ups:
        srv.update_allocs_from_client(ups)
    return len(ups)


def migrating(state, node_ids) -> dict:
    """{alloc id: job id} of the live allocs on the nodes that the
    drainer marked for migration."""
    return {a.id: a.job_id for nid in node_ids
            for a in state.allocs_by_node(nid)
            if not a.terminal_status()
            and a.desired_transition.should_migrate()}


def drain_pass(srv, drained) -> dict:
    """One NodeDrainer pass, timed, with its marks per job."""
    before = migrating(srv.state, drained)
    t0 = time.perf_counter()
    n = srv.drainer.run_once()
    ms = 1e3 * (time.perf_counter() - t0)
    per_job: dict = {}
    for aid, jid in migrating(srv.state, drained).items():
        if aid not in before:
            per_job[jid] = per_job.get(jid, 0) + 1
    return {"marks": n, "ms": ms, "per_job": per_job}


def plan_view(resp) -> dict:
    return {"annotations": resp["Annotations"], "changes": resp["Changes"],
            "diff": resp["Diff"], "failed": sorted(resp["FailedTGAllocs"])}


def child_key(job_id: str) -> str:
    """A periodic or dispatched child's id without its launch time."""
    for sep in ("/periodic-", "/dispatch-"):
        if sep in job_id:
            return job_id.split(sep, 1)[0] + sep + "*"
    return job_id


def lifecycle_outcome(srv, drained) -> dict:
    """What two runs of the lifecycle are compared on: live placements
    by (job, alloc name, node), deployments by (job, version, status,
    description), each job's version and stability, and the drained
    nodes' drain strategy and eligibility. Children are keyed without
    their launch time."""
    state = srv.state
    placed = sorted(
        (child_key(a.job_id), child_key(a.name), a.node_id)
        for a in state.allocs() if not a.terminal_status())
    deps = sorted((d.job_id, d.job_version, d.status, d.status_description)
                  for d in state.deployments())
    versions = sorted((child_key(j.id), j.version, j.stable, j.parent_id)
                      for j in state.jobs())
    nodes = sorted((nid, state.node_by_id(nid).drain_strategy is None,
                    state.node_by_id(nid).scheduling_eligibility)
                   for nid in drained)
    return {"placed": placed, "deployments": deps, "versions": versions,
            "drained_nodes": nodes}


def check_lifecycle(srv, jobs, drained, cfg: dict, children) -> None:
    """The checks every lifecycle run ends with: no live alloc on a
    drained node, each drained node's strategy cleared and the node
    ineligible, every group back at its count, no node over capacity,
    every eval complete, each child registered with its parent and
    placed."""
    state = srv.state
    left = [a.id for nid in drained for a in state.allocs_by_node(nid)
            if not a.terminal_status()]
    check(not left, f"{len(left)} live allocs left on drained nodes")
    for nid in drained:
        n = state.node_by_id(nid)
        check(n.drain_strategy is None and not n.drain,
              f"drained node {nid} still has its strategy")
        check(n.scheduling_eligibility == "ineligible",
              f"drained node {nid} is {n.scheduling_eligibility}")
    for job in jobs:
        live = live_allocs(srv, job)
        check(len(live) == cfg["count"],
              f"{job.id}: {len(live)} live allocs, want {cfg['count']}")
    check_server_state(srv, len(jobs) * cfg["count"]
                       + len(children) * cfg["child"])
    for parent, cid in children:
        child = state.job_by_id(parent.namespace, cid)
        check(child is not None and child.parent_id == parent.id,
              f"child {cid} not registered under {parent.id}")
        n = len(live_allocs(srv, child))
        check(n == cfg["child"], f"child {cid}: {n} allocs placed")


# -- the lifecycle driven by hand: deterministic, for card against CPU and
# -- for nomad_tpu against the port (tests/test_torch_lifecycle.py)

def lockstep_lead(srv) -> None:
    """Enable the leader's broker, plan queue, blocked evals and plan
    applier without a worker or watcher thread: drive_batches runs the
    batch worker, and the watchers' run_once is called by hand. A nacked
    eval redelivers at once."""
    srv.eval_broker.nack_delay_s = 0.0
    srv.eval_broker.set_enabled(True)
    srv.plan_queue.set_enabled(True)
    srv.blocked_evals.set_enabled(True)
    srv.plan_applier.start()
    srv._leader = True  # the FSM side channels enqueue evals


def wait_until(cond, what: str, timeout_s: float = 120.0) -> None:
    deadline = time.perf_counter() + timeout_s
    while not cond():
        check(time.perf_counter() < deadline,
              f"{what}: not after {timeout_s} s")
        time.sleep(0.02)


def nacks_due(broker) -> bool:
    """Whether a nacked eval waits in the broker's delay heap for its
    requeue (the broker's delay thread moves one at most 0.2 s after
    it is due)."""
    with broker._lock:
        return bool(broker._delayed) and \
            broker._delayed[0][0] <= time.time_ns()


def drive_batches(srv) -> list:
    """The batch worker driven by hand until the broker holds nothing:
    each round dequeues up to two batches, solves the second while the
    first's commit is pending (it chains on the first's used'), then
    commits both in FIFO order. A round starts only once every nacked
    eval is back in the ready queue, so each round dequeues the same
    evals in the same order on every run. Returns each batch's (evals,
    chained, chain accepted, verdict)."""
    w, broker = srv.tpu_worker, srv.eval_broker
    verdicts = []
    while True:
        wait_until(lambda: not nacks_due(broker), "a nacked eval's requeue",
                   timeout_s=10.0)
        solved = []
        for _ in range(2):
            got = []
            while len(got) < SERVER_BATCH:
                ev, tok = broker.dequeue(w.schedulers, timeout_s=0.05)
                if ev is None:
                    break
                got.append((ev, tok))
            if not got:
                break
            pending, snap, chained_on = w._solve_batch([e for e, _ in got])
            committed, outcome = threading.Event(), {"ok": None}
            w._prev = (pending, committed, outcome,
                       chained_on[1] if chained_on else snap.index)
            solved.append((got, pending, snap, committed, outcome,
                           chained_on))
        for got, pending, snap, committed, outcome, chained_on in solved:
            w._commit(got, pending, snap, committed, outcome, chained_on)
            verdicts.append((len(got), chained_on is not None,
                             pending.chain_accepted, outcome["ok"]))
        if not solved and broker.pending_count() == 0 \
                and broker.inflight_count() == 0 and not broker._delayed:
            return verdicts


def lifecycle_lockstep(srv, structs, make, nodes, drained,
                       cfg: dict) -> dict:
    """The lifecycle's five steps at one seed with every eval solved by
    drive_batches and every watcher pass called by hand, on a Server the
    caller built with the GPU batch worker (nomad_tpu's Server in the
    tests: `structs` and `make` come from the server's own package).
    Returns lifecycle_outcome plus the plans, the drain passes' marks and
    the batch verdicts."""
    lockstep_lead(srv)
    srv.raft_apply("node_register_batch", [n.copy() for n in nodes])
    state = srv.state
    jobs = [lifecycle_job(structs, make, f"life-{j}", cfg["count"], cfg)
            for j in range(cfg["jobs"])]
    verdicts = []
    for job in jobs:
        srv.job_register(job)
    verdicts += drive_batches(srv)
    for job in jobs:
        mark_healthy(srv, job)
    srv.deployment_watcher.run_once()
    out = {}
    # 1. job plan: a new job, and job 0 with a new task env
    before = state.latest_index()
    new = lifecycle_job(structs, make, "life-new", cfg["count"], cfg)
    roll0 = bumped(state.job_by_id(jobs[0].namespace, jobs[0].id), "2")
    out["plans"] = [plan_view(srv.job_plan(new)),
                    plan_view(srv.job_plan(roll0))]
    check(state.latest_index() == before, "job_plan wrote to the store")
    # 2. canary rollouts: promoted, then rolled to success
    rolled = jobs[1:1 + cfg["roll"]]
    for job in rolled:
        srv.job_register(bumped(state.job_by_id(job.namespace, job.id), "2"))
    verdicts += drive_batches(srv)
    for job in rolled:
        mark_healthy(srv, job)
        srv.deployment_promote(latest_dep(state, job).id)
    verdicts += drive_batches(srv)
    rounds = 0
    while True:
        for job in rolled:
            mark_healthy(srv, job)
        srv.deployment_watcher.run_once()
        todo = [j for j in rolled
                if latest_dep(state, j).status != "successful"]
        if not todo:
            break
        rounds += 1
        check(rounds <= 4 * cfg["count"] // cfg["max_parallel"] + 4,
              f"rollout not done after {rounds} rounds")
        for job in todo:
            srv.job_force_evaluate(job.namespace, job.id)
        verdicts += drive_batches(srv)
    out["deploy_rounds"] = rounds
    # 3. auto-revert: the canaries reported unhealthy
    rj = jobs[cfg["revert"]]
    srv.job_register(bumped(state.job_by_id(rj.namespace, rj.id), "bad"))
    verdicts += drive_batches(srv)
    d = latest_dep(state, rj)
    srv.alloc_set_health(d.id, [], [a.id for a in live_allocs(srv, rj)
                                    if a.deployment_id == d.id])
    srv.deployment_watcher.run_once()
    verdicts += drive_batches(srv)
    # 4. node drain: two rate-limited passes, then the deadline forced
    for nid in drained:
        srv.node_update_drain(nid, structs.DrainStrategy(deadline_s=3600))
    verdicts += drive_batches(srv)
    passes = []
    for _ in range(2):
        passes.append(drain_pass(srv, drained))
        check(max(passes[-1]["per_job"].values(), default=0)
              <= cfg["migrate"], f"a drainer pass marked {passes[-1]}")
        verdicts += drive_batches(srv)
        report_running(srv, jobs)
    for nid in drained:
        srv.node_update_drain(nid, structs.DrainStrategy(deadline_s=-1))
    passes.append(drain_pass(srv, drained))
    verdicts += drive_batches(srv)
    report_running(srv, jobs)
    passes.append(drain_pass(srv, drained))
    # 5. a forced periodic launch and a dispatch
    per, par = child_jobs(structs, make, cfg["child"])
    srv.job_register(per)
    srv.job_register(par)
    children = [(per, srv.periodic.force_launch(per.namespace, per.id)),
                (par, srv.job_dispatch(par.namespace, par.id,
                                       meta={"run": "1"})[0])]
    verdicts += drive_batches(srv)
    check_lifecycle(srv, jobs, drained, cfg, children)
    out.update(lifecycle_outcome(srv, drained))
    out["drain_passes"] = [sorted(p["per_job"].items()) for p in passes]
    out["verdicts"] = verdicts
    return out


# -- the lifecycle at c2m's width on a running Server (worker, watcher,
# -- drainer and periodic threads)

def wait_settled(srv, timeout_s: float = 600.0) -> None:
    """Until the broker, the worker and the plan queue hold nothing and
    no eval in the store is pending (a nacked eval waits out the
    broker's nack delay in between)."""
    deadline = time.perf_counter() + timeout_s
    while True:
        check(srv.wait_for_evals(max(0.0, deadline - time.perf_counter())),
              f"evals still in flight after {timeout_s} s")
        if srv.eval_broker.pending_count() == 0 and not any(
                e.status == "pending" for e in srv.state.evals()):
            return
        check(time.perf_counter() < deadline,
              f"evals pending after {timeout_s} s")
        time.sleep(0.05)


def timed_passes(watcher) -> list:
    """Wrap a watcher's run_once so each pass (its poll thread's too)
    records its milliseconds in the returned list."""
    passes = []
    real = watcher.run_once

    def run_once(*args):
        t0 = time.perf_counter()
        try:
            return real(*args)
        finally:
            passes.append(1e3 * (time.perf_counter() - t0))

    watcher.run_once = run_once
    return passes


def pass_stats(ms: list) -> dict:
    return {"passes": len(ms),
            "median_ms": statistics.median(ms) if ms else None,
            "max_ms": max(ms) if ms else None}


def lifecycle_scenario(device: str, n_nodes: int, seed: int,
                       on_step) -> dict:
    """The lifecycle's five steps at c2m's width through the Server's
    endpoints, on a Server with the pipelined GPU batch worker (batches
    of SERVER_BATCH, small_batch_threshold 0 so that every solve, the
    10-canary ones included, runs on the card, as tests/test_canary.py
    runs nomad_tpu's) and the deployment watcher, node drainer and
    periodic dispatcher on their own threads. Setup (the fleet, the jobs
    and their first deployments driven to successful) runs before the
    launch counters are zeroed; they are read after step 5. The drain
    step stops the drainer's thread and runs its passes by hand, timed.
    Returns the server (still running), the launch counts and each
    step's numbers."""
    from nomad_tpu_torch import metrics
    from nomad_tpu_torch.metrics import Registry
    from nomad_tpu_torch.structs import structs as S

    metrics._install_registry(Registry())
    srv, lead_s = start_server(device, c2m_nodes(n_nodes),
                               small_batch_threshold=0)
    state = srv.state
    cfg = LIFE
    tg_name = "web"
    watcher_ms = timed_passes(srv.deployment_watcher)
    t0 = time.perf_counter()
    jobs = [lifecycle_job(S, make_job, f"life-{j}", cfg["count"], cfg)
            for j in range(cfg["jobs"])]
    register_and_wait(srv, jobs)
    for job in jobs:
        mark_healthy(srv, job)
    wait_until(lambda: all(
        latest_dep(state, j).status == "successful"
        and state.job_by_id(j.namespace, j.id).stable for j in jobs),
        "the first deployments successful and stable")
    on_step("lifecycle.setup", time.perf_counter() - t0,
            establish_leadership_s=lead_s,
            allocs=cfg["jobs"] * cfg["count"])
    tk.reset_launch_counts()
    m0 = metrics.snapshot()
    steps: dict = {}

    def step(name: str, fn) -> None:
        trace.clear_finished()
        n_evals = len(state.evals())
        w0 = len(watcher_ms)
        t = time.perf_counter()
        extra = fn()
        wall = time.perf_counter() - t
        traces = batch_traces()
        nums = {"wall_s": wall, "evals": len(state.evals()) - n_evals,
                "batches": len(traces),
                "compact_batches": sum(
                    1 for tr in traces
                    if any(sp.name == "device.wait" for sp in tr.spans)),
                "watcher": pass_stats(watcher_ms[w0:]),
                "spans_ms": span_sums_ms(traces), **extra}
        steps[name] = nums
        on_step(f"lifecycle.{name}", wall, **nums)

    def do_plan() -> dict:
        before = (state.latest_index(), len(state.allocs()),
                  len(state.deployments()), len(state.jobs()))
        new = lifecycle_job(S, make_job, "life-new", cfg["count"], cfg)
        roll0 = bumped(state.job_by_id(jobs[0].namespace, jobs[0].id), "2")
        ms, k1, ann = [], [], []
        for cand in (new, roll0):
            k0 = tk.solve_placement_compact.launches
            t = time.perf_counter()
            resp = srv.job_plan(cand)
            ms.append(1e3 * (time.perf_counter() - t))
            k1.append(tk.solve_placement_compact.launches - k0)
            check(resp["Changes"] is True, f"plan of {cand.id}: no changes")
            ann.append(resp["Annotations"]["DesiredTGUpdates"][tg_name])
        check(ann[0]["place"] == cfg["count"],
              f"the new job's plan places {ann[0]['place']}")
        check(ann[1]["canary"] == cfg["canary"]
              and ann[1]["destructive"] == 0,
              f"job 0's plan: {ann[1]}")
        after = (state.latest_index(), len(state.allocs()),
                 len(state.deployments()), len(state.jobs()))
        check(after == before, f"job_plan moved the store: {before} -> "
              f"{after}")
        # (a launch is counted on the card alone: the CPU twins count none)
        check(device != "cuda" or all(k >= 1 for k in k1),
              f"K1 launches per plan: {k1}")
        return {"plan_ms": ms, "k1_per_plan": k1, "annotations": ann}

    def do_deploy() -> dict:
        rolled = jobs[1:1 + cfg["roll"]]
        for job in rolled:
            srv.job_register(
                bumped(state.job_by_id(job.namespace, job.id), "2"))
        wait_settled(srv)
        for job in rolled:
            d = latest_dep(state, job)
            n = sum(1 for a in live_allocs(srv, job) if a.deployment_id == d.id)
            check(n == cfg["canary"], f"{job.id}: {n} canaries placed")
            check(mark_healthy(srv, job) == cfg["canary"],
                  f"{job.id}: canaries to mark healthy")
            srv.deployment_promote(d.id)
        wait_settled(srv)
        rounds = 0
        while True:
            for job in rolled:
                mark_healthy(srv, job)
            todo = []
            for job in rolled:
                v = state.job_by_id(job.namespace, job.id).version
                new_live = [a for a in live_allocs(srv, job)
                            if a.job.version == v]
                if len(new_live) < cfg["count"]:
                    todo.append(job)
            if not todo:
                break
            rounds += 1
            check(rounds <= 2 * cfg["count"] // cfg["max_parallel"] + 2,
                  f"rollout not done after {rounds} rounds")
            for job in todo:
                srv.job_force_evaluate(job.namespace, job.id)
            wait_settled(srv)
        wait_until(lambda: all(
            latest_dep(state, j).status == "successful"
            and state.job_by_id(j.namespace, j.id).stable for j in rolled),
            "the rollouts successful and stable")
        for job in rolled:
            stored = state.job_by_id(job.namespace, job.id)
            live = live_allocs(srv, job)
            check(len(live) == cfg["count"]
                  and all(a.job.version == stored.version for a in live),
                  f"{job.id}: not all {cfg['count']} allocs on version "
                  f"{stored.version}")
        return {"rounds": rounds, "jobs": len(rolled),
                "allocs_rolled": len(rolled) * cfg["count"]}

    def do_revert() -> dict:
        rj = jobs[cfg["revert"]]
        stable = state.job_by_id(rj.namespace, rj.id)
        srv.job_register(bumped(stable, "bad"))
        wait_settled(srv)
        bad_v = state.job_by_id(rj.namespace, rj.id).version
        d = latest_dep(state, rj)
        canaries = [a.id for a in live_allocs(srv, rj)
                    if a.deployment_id == d.id]
        check(len(canaries) == cfg["canary"],
              f"revert: {len(canaries)} canaries placed")
        srv.alloc_set_health(d.id, [], canaries)
        wait_until(lambda: state.deployment_by_id(d.id).status == "failed"
                   and state.job_by_id(rj.namespace, rj.id).version > bad_v,
                   "the watcher's fail and auto-revert")
        wait_settled(srv)
        reverted = state.job_by_id(rj.namespace, rj.id)
        check(not reverted.specification_changed(stable),
              "the reverted job's spec is not the stable one's")
        check(all(state.alloc_by_id(c).terminal_status() for c in canaries),
              "a canary of the failed deployment is still live")
        env = stable.task_groups[0].tasks[0].env
        live = live_allocs(srv, rj)
        check(len(live) == cfg["count"]
              and all(a.job.task_groups[0].tasks[0].env == env
                      for a in live),
              f"revert: {len(live)} live allocs, not all on the stable spec")
        # The revert's own deployment (nomad_tpu's behaviour, which the
        # port follows): its allocs are updated in place and keep their
        # old deployment id, so it stays running with nothing placed.
        d2 = latest_dep(state, rj)
        return {"description": state.deployment_by_id(d.id)
                .status_description,
                "versions": [stable.version, bad_v, reverted.version],
                "revert_deployment": [d2.status,
                                      d2.task_groups[tg_name].placed_allocs]}

    drained = random.Random(seed).sample(
        sorted(n.id for n in state.nodes()),
        int(n_nodes * cfg["drain_ratio"]))

    def do_drain() -> dict:
        srv.drainer.stop()  # its passes run by hand below, timed
        t = time.perf_counter()
        for nid in drained:
            srv.node_update_drain(nid, S.DrainStrategy(deadline_s=3600))
        mark_s = time.perf_counter() - t
        wait_settled(srv)
        passes = []
        running = []
        for _ in range(2):
            p = drain_pass(srv, drained)
            check(max(p["per_job"].values(), default=0) <= cfg["migrate"],
                  f"a drainer pass marked {p['per_job']}")
            passes.append(p)
            wait_settled(srv)
            running.append(report_running(srv, jobs))
        for nid in drained:
            srv.node_update_drain(nid, S.DrainStrategy(deadline_s=-1))
        wait_settled(srv)
        passes.append(drain_pass(srv, drained))
        wait_settled(srv)
        running.append(report_running(srv, jobs))
        passes.append(drain_pass(srv, drained))
        srv.drainer.start()
        return {"drained": len(drained), "drain_calls_s": mark_s,
                "marks": [p["marks"] for p in passes],
                "max_per_group": [max(p["per_job"].values(), default=0)
                                  for p in passes],
                "pass_ms": [p["ms"] for p in passes],
                "reported_running": running}

    children = []

    def do_periodic() -> dict:
        per, par = child_jobs(S, make_job, cfg["child"])
        srv.job_register(per)
        srv.job_register(par)
        children.append(
            (per, srv.periodic.force_launch(per.namespace, per.id)))
        children.append((par, srv.job_dispatch(
            par.namespace, par.id, meta={"run": "1"})[0]))
        wait_settled(srv)
        return {"children": [c for _, c in children]}

    for name, fn in (("plan", do_plan), ("deploy", do_deploy),
                     ("revert", do_revert), ("drain", do_drain),
                     ("periodic", do_periodic)):
        step(name, fn)
    launches = launch_counts()
    check_lifecycle(srv, jobs, drained, cfg, children)
    m1 = metrics.snapshot()
    whole = wave_numbers(m0, m1, [], 1.0, 0, 0)
    return {"srv": srv, "launches": launches, "steps": steps,
            "counters": m1["counters"],
            "compact_batches": sum(s["compact_batches"]
                                   for s in steps.values()),
            "chained_batches": whole["chained_batches"],
            "partial_commits": whole["partial_commits"],
            "watcher": pass_stats(watcher_ms)}


def check_lifecycle_run(res) -> None:
    """No device failover or failed batch, the worker's resident tensors
    on cuda:0, K1 once per compact batch (and once per plan), K2 not
    donated at least once."""
    srv, c = res["srv"], res["counters"]
    w = srv.tpu_worker
    check(c.get("nomad.worker.device_failover", 0) == 0,
          "lifecycle: a device failover")
    check(c.get("nomad.worker.invoke.failed", 0) == 0,
          "lifecycle: a batch failed to solve or commit")
    cuda0 = torch.device("cuda", 0)
    r = w._resident
    check(r is not None and r._cap_dev.device == cuda0
          and r._used_dev.device == cuda0,
          "lifecycle: the worker's resident tensors are not on cuda:0")
    k1 = res["launches"]["solve_placement_compact"]
    want = res["compact_batches"] + len(res["steps"]["plan"]["plan_ms"])
    check(res["compact_batches"] > 0 and k1 >= want,
          f"lifecycle: K1 ran {k1} times for {want} compact solves")
    check(res["launches"]["scatter_rows_copy"] >= 1,
          "lifecycle: K2's non-donated mode was not launched")


def lifecycle_recorders() -> dict:
    """Recorders for the lifecycle phase's first K1 call and its first
    non-donated K2 call."""
    return {
        "solve_placement_compact": Recorder(solver_mod,
                                            "solve_placement_compact"),
        "scatter_rows_copy": Recorder(solver_mod, "scatter_rows",
                                      keep=lambda a: a[3] is False),
    }


def lifecycle_small(device: str, nodes: list, drained: list) -> dict:
    """LIFE_SMALL's lifecycle driven by hand (lifecycle_lockstep) on a
    fresh Server with the GPU batch worker on `device`."""
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.structs import structs as S

    srv = Server(use_tpu_batch_worker=True, scheduler_config=SchedulerConfig(
        device=device, small_batch_threshold=0))
    srv.tpu_worker.batch_size = SERVER_BATCH
    try:
        return lifecycle_lockstep(srv, S, make_job, nodes, drained,
                                  LIFE_SMALL)
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# tenancy: namespaces, ACL, CSI volumes with their claims and the volume
# watcher, services, secrets with Vault task tokens, scaling policies,
# search, the watch hub and the event stream, through the Server's own
# endpoints (nomad_tpu's server.py, state/, acl/, stream/, ported)
# ---------------------------------------------------------------------------

# c2m's fleet and job shape. dc1's nodes run a healthy node-capable CSI
# plugin `ebs`; `data_jobs` jobs in team-a ask for the multi-writer CSI
# volume `data` (every alloc lands on dc1: the screen masks K1 to dc1's
# nodes), `jobs` more carry a scaling stanza (min 1, max 2 x count) across
# default, team-a and team-b; the fleet registers through the
# NodeRegisterBatcher from `threads` threads.
TEN = {"nodes": 10000, "count": 1000, "data_jobs": 4, "jobs": 16,
       "scale_to": 1200, "vault_count": 10, "threads": 32,
       "token_ttl_s": 0.5}
# the same steps at 200 nodes, every batch and watcher pass by hand, the
# fleet registered from one thread (one batch entry a node)
TEN_SMALL = {"nodes": 200, "count": 50, "data_jobs": 4, "jobs": 16,
             "scale_to": 60, "vault_count": 2, "threads": 1,
             "token_ttl_s": 0.05}
TEN_PLUGIN = "ebs"
TEN_PLUGIN_DC = "dc1"
TEN_SPACES = ("default", "team-a", "team-b")
TEN_POLICY = ('namespace "team-a" {\n  policy = "read"\n'
              '  capabilities = ["submit-job"]\n}\n')
TEN_VAULT = ["db-read"]
TEN_TG = "web"
# topics the store publishes (nomad_tpu's state/events.py table map)
EVENT_TOPICS = ("Node", "Job", "Evaluation", "Allocation", "Deployment",
                "Service", "Volume")


def port_kit():
    """The port's modules a tenancy run reaches besides the Server (the
    tests hand nomad_tpu's to the same functions)."""
    from nomad_tpu_torch.acl import structs as acl
    from nomad_tpu_torch.server.core_sched import CoreScheduler
    from nomad_tpu_torch.server.search import prefix_search
    from nomad_tpu_torch.structs import structs as S

    return types.SimpleNamespace(S=S, acl=acl, core=CoreScheduler,
                                 prefix_search=prefix_search)


def with_plugin(nodes: list, node_class) -> list:
    """The fleet with the CSI plugin fingerprinted on dc1's nodes (their
    class recomputed: the plugin is part of it)."""
    for n in nodes:
        if n.datacenter == TEN_PLUGIN_DC:
            n.csi_plugins[TEN_PLUGIN] = {"healthy": True, "node": True,
                                         "controller": False,
                                         "version": "1.0.0"}
            n.computed_class = node_class(n)
    return nodes


def csi_job(S, make, job_id: str, ns: str, count: int, source: str):
    job = make(job_id, count)
    job.namespace = ns
    job.task_groups[0].volumes = {
        "data": S.VolumeRequest(name="data", type="csi", source=source)}
    return job


def scaled_job(S, make, job_id: str, ns: str, count: int):
    job = make(job_id, count)
    job.namespace = ns
    job.task_groups[0].scaling = S.ScalingPolicy(min=1, max=2 * count,
                                                 enabled=True)
    return job


def vault_job(make, job_id: str, count: int, policies: list):
    job = make(job_id, count)
    job.namespace = "team-a"
    job.task_groups[0].tasks[0].vault = {"policies": list(policies)}
    return job


def job_live(state, ns: str, job_id: str) -> list:
    return sorted((a for a in state.allocs_by_job(ns, job_id)
                   if not a.terminal_status()), key=lambda a: a.name)


def refused(fn) -> str:
    """The error a call raises, as 'Type: message'; '' if it returns."""
    try:
        fn()
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    return ""


class EventTap:
    """One subscription over every topic on a server's event broker,
    held across a run and drained on its own thread. `sync` waits until
    it has read everything published so far (the store publishes inside
    each write, so once a write returns its events are in the ring)."""

    def __init__(self, broker) -> None:
        self.sub = broker.subscribe({"*": ["*"]})
        self.events: list = []
        self.error = None
        self._want = threading.Event()
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="event-tap")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                got = self.sub.next(timeout_s=0.05)
            except Exception as e:  # fell off the ring, or closed
                self.error = f"{type(e).__name__}: {e}"
                self._synced.set()
                return
            self.events.extend(got)
            if not got and self._want.is_set():
                self._want.clear()
                self._synced.set()

    def sync(self) -> int:
        """Read up to now; returns how many events are held."""
        self._synced.clear()
        self._want.set()
        check(self._synced.wait(120), "the event tap did not catch up")
        check(self.error is None, f"event subscription lost: {self.error}")
        return len(self.events)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.sub.close()


def by_topic(events) -> dict:
    out = {t: 0 for t in EVENT_TOPICS}
    for e in events:
        out[e.topic] = out.get(e.topic, 0) + 1
    return out


def by_type(events, topic: str) -> dict:
    out: dict = {}
    for e in events:
        if e.topic == topic:
            out[e.type] = out.get(e.type, 0) + 1
    return out


def event_view(events) -> list:
    """The event sequence as (index, [(topic, type, key)] sorted within
    the index). Keys the server mints (alloc, eval and deployment ids)
    are replaced by what names them: (job, alloc name), (job, trigger,
    status), (job, version, status)."""
    blocks: dict = {}
    for e in events:
        p = e.payload
        if e.topic == "Allocation":
            key = (p.job_id, p.name)
        elif e.topic == "Evaluation":
            key = (p.job_id, p.triggered_by, p.status)
        elif e.topic == "Deployment":
            key = (p.job_id, p.job_version, p.status)
        else:
            key = e.key
        blocks.setdefault(e.index, []).append((e.topic, e.type, key))
    return [(i, sorted(blocks[i], key=repr)) for i in sorted(blocks)]


def tenancy_outcome(srv) -> dict:
    """What two tenancy runs are compared on, ids normalised: live
    placements by (namespace, job, alloc name, node), each volume's
    claims by the claiming alloc's (job, name, node) with the claim's
    index, services, scaling policies and events, namespaces, ACL
    policies and tokens (a task token's name without its alloc id),
    secrets (values included)."""
    state = srv.state
    placed = sorted((a.namespace, a.job_id, a.name, a.node_id)
                    for a in state.allocs() if not a.terminal_status())
    claims = {}
    for v in state.volumes():
        rows = []
        for aid, c in v.claims.items():
            a = state.alloc_by_id(aid)
            rows.append(((a.job_id, a.name) if a is not None else ("?", aid))
                        + (c.node_id, c.read_only, c.create_index))
        claims[f"{v.namespace}/{v.id}"] = sorted(rows)
    volumes = sorted((v.namespace, v.id, v.access_mode, v.create_index,
                      v.modify_index) for v in state.volumes())
    services = sorted((r.id, r.service_name, r.job_id, r.node_id,
                       r.create_index)
                      for n in state.service_names()
                      for r in state.service_registrations(
                          n["namespace"], n["service_name"]))
    policies = [(p.id, p.min, p.max, p.enabled, p.create_index,
                 p.modify_index) for p in state.scaling_policies()]
    scaling_events = {}
    for p in state.scaling_policies():
        evs = state.scaling_events(p.namespace, p.job_id)
        if evs:
            scaling_events[f"{p.namespace}/{p.job_id}"] = {
                g: [(e["Count"], e["PreviousCount"], e["Message"])
                    for e in lst] for g, lst in sorted(evs.items())}
    return {
        "placed": placed, "claims": claims, "volumes": volumes,
        "services": services, "scaling_policies": policies,
        "scaling_events": scaling_events,
        "namespaces": sorted((n.name, n.description, n.create_index,
                              n.modify_index) for n in state.namespaces()),
        "acl_policies": sorted((p.name, p.rules, p.create_index,
                                p.modify_index)
                               for p in state.acl_policies()),
        "acl_tokens": sorted((re.sub(r"^task-[0-9a-f]{8}-", "task-*-",
                                     t.name), t.type, tuple(t.policies),
                              bool(t.expiration_time_ns), t.create_index,
                              t.modify_index) for t in state.acl_tokens()),
        "secrets": sorted((e.namespace, e.path, sorted(e.items.items()),
                           e.create_index, e.modify_index)
                          for e in state.secrets()),
    }


class HandDrive:
    """Every eval solved by drive_batches and every watcher pass called
    by hand: the same run on every server."""

    def __init__(self, srv) -> None:
        self.srv = srv
        self.verdicts: list = []

    def settle(self) -> None:
        self.verdicts += drive_batches(self.srv)

    def volume_pass(self, done, what: str) -> None:
        self.srv.volume_watcher.run_once()
        check(done(), what)

    def unblocked(self, job, done, what: str) -> None:
        # the release's unblock reaches the store through the unblock
        # writer's thread: wait for that write, then solve
        state = self.srv.state
        wait_until(lambda: not any(
            e.status == "blocked" for e in state.evals()
            if e.job_id == job.id), f"{what}: the unblock's write")
        self.settle()
        check(done(), what)


class ThreadDrive:
    """The running Server's own threads: the batch worker, the volume
    watcher (a pass a second) and the unblock writer."""

    def __init__(self, srv) -> None:
        self.srv = srv

    def settle(self) -> None:
        wait_settled(self.srv)

    def volume_pass(self, done, what: str) -> None:
        wait_until(done, what, timeout_s=60.0)

    def unblocked(self, job, done, what: str) -> None:
        wait_until(done, what, timeout_s=60.0)
        wait_settled(self.srv)


def ten_setup(srv, kit, nodes, make, cfg, led: bool) -> dict:
    """The fleet through Server.node_register (the NodeRegisterBatcher
    coalesces concurrent registrations into node_register_batch
    entries), two namespaces, the C1 refusal, ACL bootstrap, a team-a
    submit-job policy and a token for it, resolved."""
    S, state = kit.S, srv.state
    i0 = state.latest_index()
    t = time.perf_counter()
    chunks = [nodes[k::cfg["threads"]] for k in range(cfg["threads"])]
    errors = []

    def register(chunk):
        try:
            for n in chunk:
                srv.node_register(n.copy())
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=register, args=(c,)) for c in chunks]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(not errors, f"node_register failed: {errors[:1]}")
    register_s = time.perf_counter() - t
    entries = state.latest_index() - i0
    check(len(state.nodes()) == len(nodes),
          f"{len(state.nodes())} nodes registered, want {len(nodes)}")
    default = state.namespace_by_name("default")
    check(not led or default is not None,
          "default was not bootstrapped at leadership")
    for ns in TEN_SPACES[1:]:
        srv.namespace_upsert(S.Namespace(name=ns, description=ns))
    before = state.latest_index()
    stray = make("ten-stray", cfg["count"])
    stray.namespace = "team-c"
    c1 = refused(lambda: srv.job_register(stray))
    check(c1 == "ValueError: namespace 'team-c' does not exist",
          f"C1: a job into team-c: {c1!r}")
    check(state.latest_index() == before
          and state.job_by_id("team-c", stray.id) is None,
          "C1: the refused job moved the store")
    root = srv.acl_bootstrap()
    srv.acl_policy_upsert([kit.acl.ACLPolicy(name="team-a-submit",
                                             rules=TEN_POLICY)])
    tok = srv.acl_token_create(kit.acl.ACLToken(
        name="team-a-ci", type="client", policies=["team-a-submit"]))
    acl = srv.resolve_token(tok.secret_id)
    view = [acl.allow_namespace_op("team-a", "submit-job"),
            acl.allow_namespace_op("team-b", "submit-job"),
            srv.resolve_token(root.secret_id).is_management()]
    check(view == [True, False, True], f"resolve_token: {view}")
    return {"nodes": len(nodes), "register_threads": cfg["threads"],
            "register_s": register_s, "node_register_batch_entries": entries,
            "default_bootstrapped": default is not None,
            "c1_refused": c1, "acl": view}


def ten_volumes(srv, kit, make, cfg, drive, on_masked=None) -> dict:
    """Two CSI volumes in team-a on `ebs`; `data_jobs` c2m jobs asking
    for the multi-writer `data` land on dc1 alone, each claim written in
    its placement's commit; a count-1 job claims the single-writer
    `solo`, a second one finds it claimed; the first stopped, the
    volume watcher releases its claim and the second places;
    deregistering the claimed `data` is refused."""
    S, state = kit.S, srv.state
    for vid, mode in (("data", S.VOLUME_ACCESS_MULTI_WRITER),
                      ("solo", S.VOLUME_ACCESS_SINGLE_WRITER)):
        srv.volume_register(S.Volume(id=vid, namespace="team-a", name=vid,
                                     type="csi", plugin_id=TEN_PLUGIN,
                                     access_mode=mode))
    jobs = [csi_job(S, make, f"ten-data-{j}", "team-a", cfg["count"], "data")
            for j in range(cfg["data_jobs"])]
    if on_masked is not None:
        on_masked(True)
    for job in jobs:
        srv.job_register(job)
    drive.settle()
    if on_masked is not None:
        on_masked(False)
    live = [a for job in jobs for a in job_live(state, "team-a", job.id)]
    want = cfg["data_jobs"] * cfg["count"]
    check(len(live) == want, f"data: {len(live)} allocs placed, want {want}")
    off = [a.id for a in live
           if state.node_by_id(a.node_id).datacenter != TEN_PLUGIN_DC]
    check(not off, f"data: {len(off)} allocs off {TEN_PLUGIN_DC}")
    data = state.volume_by_id("team-a", "data")
    check(set(data.claims) == {a.id for a in live},
          f"data holds {len(data.claims)} claims for {len(live)} allocs")
    late = [a.id for a in live
            if data.claims[a.id].create_index != a.create_index]
    check(not late, f"data: {len(late)} claims not in their alloc's commit")
    solo1 = csi_job(S, make, "ten-solo-1", "team-a", 1, "solo")
    solo2 = csi_job(S, make, "ten-solo-2", "team-a", 1, "solo")
    srv.job_register(solo1)
    drive.settle()
    first = job_live(state, "team-a", solo1.id)
    check(len(first) == 1 and set(state.volume_by_id("team-a", "solo")
                                  .claims) == {first[0].id},
          "solo: the first job's claim")
    ev2 = srv.job_register(solo2)
    drive.settle()
    e2 = state.eval_by_id(ev2)
    second = {"eval": e2.status, "failed": sorted(e2.failed_tg_allocs),
              "blocked": sorted(e.status for e in state.evals()
                                if e.job_id == solo2.id and e.id != ev2),
              "placed": len(job_live(state, "team-a", solo2.id))}
    check(second["placed"] == 0, f"solo: the second job placed: {second}")
    srv.job_deregister("team-a", solo1.id)
    drive.settle()
    drive.volume_pass(
        lambda: first[0].id not in state.volume_by_id("team-a", "solo")
        .claims, "solo: the watcher released the stopped job's claim")

    def second_claims():
        got = job_live(state, "team-a", solo2.id)
        return (len(got) == 1 and set(state.volume_by_id("team-a", "solo")
                                      .claims) == {got[0].id})

    drive.unblocked(solo2, second_claims,
                    "solo: the second job placed and claimed after the "
                    "release")
    dereg = refused(lambda: srv.volume_deregister("team-a", "data"))
    check(dereg == f"ValueError: volume data has {want} active claims",
          f"volume_deregister of the claimed data: {dereg!r}")
    nodes_dc1 = sum(1 for n in state.nodes()
                    if n.datacenter == TEN_PLUGIN_DC)
    return {"data_allocs": len(live), "data_claims": len(data.claims),
            "plugin_nodes": nodes_dc1, "solo_second": second,
            "deregister_refused": dereg}


def ten_jobs(srv, kit, make, cfg, drive) -> dict:
    """`jobs` c2m jobs with a scaling stanza across the three namespaces
    (one policy each, synced at register), job_scale on the first (one
    scaling event), then prefix_search on the job ids."""
    S, state = kit.S, srv.state
    jobs = [scaled_job(S, make, f"ten-job-{j}", TEN_SPACES[j % 3],
                       cfg["count"]) for j in range(cfg["jobs"])]
    for job in jobs:
        srv.job_register(job)
    drive.settle()
    for job in jobs:
        n = len(job_live(state, job.namespace, job.id))
        check(n == cfg["count"], f"{job.id}: {n} allocs placed")
    pols = state.scaling_policies()
    check(len(pols) == cfg["jobs"]
          and {p.id for p in pols} == {f"{j.namespace}/{j.id}/{TEN_TG}"
                                       for j in jobs},
          f"{len(pols)} scaling policies synced, want {cfg['jobs']}")
    target = jobs[0]
    srv.job_scale(target.namespace, target.id, TEN_TG, cfg["scale_to"],
                  message="tenancy scale")
    drive.settle()
    n = len(job_live(state, target.namespace, target.id))
    check(n == cfg["scale_to"], f"{target.id}: {n} allocs after the scale")
    evs = state.scaling_events(target.namespace, target.id).get(TEN_TG, [])
    check(len(evs) == 1 and evs[0]["Count"] == cfg["scale_to"]
          and evs[0]["PreviousCount"] == cfg["count"],
          f"scaling events: {evs}")
    found = kit.prefix_search(state, "ten-job-", "jobs", "default")
    want = sorted(j.id for j in jobs if j.namespace == "default")
    check(found["Matches"].get("jobs") == want,
          f"prefix_search: {found}")
    return {"jobs": len(jobs), "scaling_policies": len(pols),
            "scaled": [target.id, cfg["count"], cfg["scale_to"]],
            "search_matches": len(want)}


def ten_services(srv, kit, cfg, drive) -> dict:
    """A service registration for each of one job's allocs; a blocking
    watch (get_client_allocs through the watch hub) on the node of one
    of them; the job stopped: the watch wakes, the clients' deregister
    (services_deregister_alloc) removes half the rows and service_gc
    sweeps the rest."""
    S, state = kit.S, srv.state
    job = state.job_by_id("team-a", "ten-job-1")
    live = job_live(state, job.namespace, job.id)
    regs = [S.ServiceRegistration(
        id=f"{job.id}/{a.name}", service_name="ten-web",
        namespace=job.namespace, node_id=a.node_id, job_id=job.id,
        alloc_id=a.id, task_name=TEN_TG, port=8080) for a in live]
    srv.services_register(regs)
    n_reg = len(state.service_registrations(job.namespace, "ten-web"))
    check(n_reg == len(live), f"services: {n_reg} of {len(live)} stored")
    node = next(a.node_id for a in live
                if state.node_by_id(a.node_id).datacenter == TEN_PLUGIN_DC)
    min_index = state.latest_index() + 1
    woke = {}

    def watch():
        t = time.perf_counter()
        allocs, index = srv.get_client_allocs(node, min_index, 60.0)
        woke.update(index=index, s=time.perf_counter() - t,
                    stopped=sum(1 for a in allocs if a.job_id == job.id
                                and a.desired_status == "stop"))

    watcher = threading.Thread(target=watch)
    watcher.start()
    srv.job_deregister(job.namespace, job.id)
    drive.settle()
    watcher.join(60)
    check(woke.get("index", 0) >= min_index and woke["stopped"] >= 1,
          f"the watch on {node} did not see its alloc stop: {woke}")
    stopped = [a.id for a in live]
    half = stopped[:len(stopped) // 2]
    for aid in half:
        srv.services_deregister_alloc(aid)
    swept = kit.core(srv, state.snapshot()).service_gc()
    left = state.service_registrations(job.namespace, "ten-web")
    check(not left and swept == len(stopped) - len(half),
          f"services: {len(left)} left, service_gc swept {swept}")
    return {"registered": n_reg, "deregistered_by_alloc": len(half),
            "service_gc_swept": swept, "watch_woke": woke["index"]
            >= min_index, "watch_stopped_allocs": woke["stopped"]}


def ten_secrets(srv, kit, make, cfg, drive) -> dict:
    """A secret; with the operator's Vault allowlist set, a job whose
    vault policies lie in it is admitted and one of its allocs derives
    and renews a task token; a job outside it is refused at admission;
    a token derived with the TTL shortened on the instance expires and
    token_gc sweeps it."""
    S, state = kit.S, srv.state
    srv.secret_upsert(S.SecretEntry(path="db/creds", namespace="team-a",
                                    items={"user": "app", "pass": "s3cr3t"}))
    srv.vault_allowed_policies = list(TEN_VAULT)
    good = vault_job(make, "ten-vault", cfg["vault_count"], TEN_VAULT)
    srv.job_register(good)
    drive.settle()
    live = job_live(state, "team-a", good.id)
    check(len(live) == cfg["vault_count"], f"vault job: {len(live)} placed")
    tok = srv.derive_task_token(live[0].id, "web")
    stored = state.acl_token_by_secret(tok["secret_id"])
    check(stored is not None and stored.policies == TEN_VAULT,
          f"derived token: {stored}")
    ttl = srv.renew_task_token(tok["accessor_id"])
    before = state.latest_index()
    bad = vault_job(make, "ten-vault-bad", cfg["vault_count"], ["root"])
    denied = refused(lambda: srv.job_register(bad))
    check(denied.startswith("PermissionError: vault policies not in the "
                            "operator allowlist"),
          f"the job outside the allowlist: {denied!r}")
    check(state.latest_index() == before
          and state.job_by_id("team-a", bad.id) is None,
          "the refused vault job moved the store")
    srv.DERIVED_TOKEN_TTL_S = cfg["token_ttl_s"]
    try:
        short = srv.derive_task_token(live[0].id, "web")
    finally:
        del srv.DERIVED_TOKEN_TTL_S
    time.sleep(2 * cfg["token_ttl_s"])
    swept = kit.core(srv, state.snapshot()).token_gc()
    check(swept == 1 and state.acl_token_by_accessor(
        short["accessor_id"]) is None
        and state.acl_token_by_accessor(tok["accessor_id"]) is not None,
        f"token_gc swept {swept}")
    return {"renewed_ttl_s": ttl, "vault_refused": denied,
            "token_gc_swept": swept}


def check_events(steps: dict, nodes: int, cfg) -> None:
    """Each step's events against its writes: a registration event per
    node; two volume registrations, a claim event per claim, the
    watcher's release; a service event per registration and per row
    removed."""
    s = steps["setup"]["events_by_type"]
    check(s["Node"].get("NodeRegistration", 0) == nodes,
          f"setup: {s['Node']} node events for {nodes} nodes")
    v = steps["volumes"]["events_by_type"]["Volume"]
    claims = cfg["data_jobs"] * cfg["count"] + 2
    check(v.get("VolumeRegistered") == 2 and v.get("VolumeClaimed") == claims
          and v.get("VolumeClaimReleased") == 1,
          f"volumes: volume events {v}, want 2 registered, {claims} "
          "claimed, 1 release")
    sv = steps["services"]["events_by_type"]["Service"]
    n = steps["services"]["registered"]
    check(sv.get("ServiceRegistration") == n
          and sv.get("ServiceDeregistration") == n,
          f"services: service events {sv}")


TEN_STEPS = ("setup", "volumes", "jobs", "services", "secrets")


def tenancy_lockstep(srv, kit, make, nodes, cfg) -> dict:
    """The tenancy steps at one seed with every eval solved by
    drive_batches and every watcher pass called by hand, on a Server the
    caller built with the GPU batch worker (nomad_tpu's Server in the
    tests: `kit` and `make` come from the server's own package). Returns
    tenancy_outcome plus each step's numbers, the event sequence and the
    batch verdicts."""
    lockstep_lead(srv)
    srv.register_batcher.start()
    tap = EventTap(srv.event_broker)
    drive = HandDrive(srv)
    out = {"steps": {}}
    try:
        for name in TEN_STEPS:
            n0 = tap.sync()
            if name == "setup":
                res = ten_setup(srv, kit, nodes, make, cfg, led=False)
            elif name == "volumes":
                res = ten_volumes(srv, kit, make, cfg, drive)
            elif name == "jobs":
                res = ten_jobs(srv, kit, make, cfg, drive)
            elif name == "services":
                res = ten_services(srv, kit, cfg, drive)
            else:
                res = ten_secrets(srv, kit, make, cfg, drive)
            got = tap.events[n0:tap.sync()]
            res.pop("register_s", None)
            res["events_by_type"] = {t: by_type(got, t)
                                     for t in EVENT_TOPICS}
            out["steps"][name] = res
        check_events(out["steps"], len(nodes), cfg)
        out["events"] = event_view(tap.events)
    finally:
        tap.close()
    out.update(tenancy_outcome(srv))
    out["verdicts"] = drive.verdicts
    return out


def tenancy_small(device: str, nodes: list) -> dict:
    """TEN_SMALL's steps driven by hand (tenancy_lockstep) on a fresh
    Server with the GPU batch worker on `device`."""
    from nomad_tpu_torch.server import Server

    srv = Server(use_tpu_batch_worker=True, scheduler_config=SchedulerConfig(
        device=device, small_batch_threshold=0))
    srv.tpu_worker.batch_size = SERVER_BATCH
    try:
        return tenancy_lockstep(srv, port_kit(), make_job,
                                [n.copy() for n in nodes], TEN_SMALL)
    finally:
        srv.shutdown()


def tenancy_recorders(armed: dict) -> dict:
    """A recorder for K1's first call while the data jobs solve (its
    groups' feasibility masked to the plugin's nodes)."""
    return {"solve_placement_compact": Recorder(
        solver_mod, "solve_placement_compact",
        keep=lambda a: armed["on"])}


def masked_nodes(args) -> int:
    """Nodes any live group of a recorded K1 call may place on: the union
    of their feasibility rows (the spread splits a job into a sub-group
    a datacenter; only dc1's has feasible nodes under the CSI screen)."""
    cap, _, _, counts, feas, fidx = args[:6]
    bits = np.unpackbits(feas.cpu().numpy(), axis=1)[:, :cap.shape[0]]
    live = (counts > 0).nonzero().flatten().cpu().numpy()
    rows = fidx.cpu().numpy()[live]
    return int(bits[rows].any(axis=0).sum())


def tenancy_scenario(device: str, cfg: dict, on_step, armed=None) -> dict:
    """The tenancy steps at c2m's width through the Server's endpoints,
    on a Server with the pipelined GPU batch worker (batches of
    SERVER_BATCH) and its watcher threads (the deployment watcher, the
    node drainer, the volume watcher, the periodic dispatcher, the GC
    timer) running, one EventTap held across the phase. The launch
    counters are zeroed just before the first registration and read
    after the last step. No client heartbeats: the heartbeat wheel is
    switched off once the fleet is registered (the other server phases
    never arm it). Returns the server (still running), the launch
    counts and each step's numbers."""
    from nomad_tpu_torch import metrics
    from nomad_tpu_torch.metrics import Registry
    from nomad_tpu_torch.server import Server

    metrics._install_registry(Registry())
    kit = port_kit()
    nodes = with_plugin(c2m_nodes(cfg["nodes"]), compute_node_class)
    srv = Server(use_tpu_batch_worker=True,
                 scheduler_config=SchedulerConfig(device=device))
    srv.tpu_worker.batch_size = SERVER_BATCH
    t = time.perf_counter()
    srv.establish_leadership()
    lead_s = time.perf_counter() - t
    tap = EventTap(srv.event_broker)
    drive = ThreadDrive(srv)
    vw_ms = timed_passes(srv.volume_watcher)
    steps: dict = {}
    state = srv.state

    def step(name: str, fn) -> None:
        trace.clear_finished()
        n0 = tap.sync()
        k0 = launch_counts()
        e0, w0 = len(state.evals()), len(vw_ms)
        t = time.perf_counter()
        extra = fn()
        wall = time.perf_counter() - t
        if device == "cuda":
            torch.cuda.synchronize()
        got = tap.events[n0:tap.sync()]
        traces = batch_traces()
        k1 = launch_counts()
        nums = {"wall_s": wall, "evals": len(state.evals()) - e0,
                "batches": len(traces),
                "launches": {k: k1[k] - k0[k] for k in k1},
                "events": by_topic(got),
                "events_by_type": {tp: by_type(got, tp)
                                   for tp in EVENT_TOPICS},
                "volume_watcher": pass_stats(vw_ms[w0:]),
                "spans_ms": span_sums_ms(traces), **extra}
        steps[name] = nums
        shown = {k: v for k, v in nums.items() if k != "events_by_type"}
        on_step(f"tenancy.{name}", wall, **shown)

    tk.reset_launch_counts()
    try:
        step("setup", lambda: dict(
            ten_setup(srv, kit, nodes, make_job, cfg, led=True),
            establish_leadership_s=lead_s))
        srv.heartbeaters.set_enabled(False)
        step("volumes", lambda: ten_volumes(
            srv, kit, make_job, cfg, drive,
            on_masked=(lambda on: armed.update(on=on)) if armed is not None
            else None))
        step("jobs", lambda: ten_jobs(srv, kit, make_job, cfg, drive))
        step("services", lambda: ten_services(srv, kit, cfg, drive))
        step("secrets", lambda: ten_secrets(srv, kit, make_job, cfg, drive))
        launches = launch_counts()
        check_events(steps, cfg["nodes"], cfg)
    finally:
        tap.close()
    live = (cfg["data_jobs"] * cfg["count"] + 1
            + (cfg["jobs"] - 2) * cfg["count"] + cfg["scale_to"]
            + cfg["vault_count"])
    check_server_state(srv, live)
    return {"srv": srv, "launches": launches, "steps": steps,
            "counters": metrics.snapshot()["counters"], "live": live,
            "events": len(tap.events),
            "volume_watcher": pass_stats(vw_ms)}


def check_tenancy_run(res) -> None:
    """No device failover or failed batch, the worker's resident tensors
    on cuda:0, K1 launched in the volumes and the jobs steps, K2 at
    least once."""
    srv, c = res["srv"], res["counters"]
    check(c.get("nomad.worker.device_failover", 0) == 0,
          "tenancy: a device failover")
    check(c.get("nomad.worker.invoke.failed", 0) == 0,
          "tenancy: a batch failed to solve or commit")
    cuda0 = torch.device("cuda", 0)
    r = srv.tpu_worker._resident
    check(r is not None and r._cap_dev.device == cuda0
          and r._used_dev.device == cuda0,
          "tenancy: the worker's resident tensors are not on cuda:0")
    for name in ("volumes", "jobs"):
        n = res["steps"][name]["launches"]["solve_placement_compact"]
        check(n >= 1, f"tenancy.{name}: K1 launched {n} times")
    check(res["launches"]["scatter_rows"] >= 1,
          "tenancy: K2 was not launched")


# ---------------------------------------------------------------------------
# replication and the cluster: three ClusterServers (nomad_tpu's
# server/cluster.py, raft_replication.py, raft_store.py and
# testing/chaos.py, ported) through a leader kill and a restart from disk
# ---------------------------------------------------------------------------

# the cluster phase at c2m's width: the fleet through the two followers'
# Node.register from 32 threads, c2m's first 25 jobs through a follower,
# the leader killed, the next 25 through the surviving follower, the
# killed server restarted from its data dir (50 of c2m's 100 jobs, cut
# to keep the run's time since the fleet, soak and scenario phases came)
CLUSTER = {"nodes": 10000, "count": 1000, "jobs": 50, "threads": 32}
# cluster_lockstep's size: 200 nodes, jobs of 50, six before the kill
# and six after, then job 0 scaled to 60 after the restart
CLUSTER_SMALL = {"nodes": 200, "count": 50, "before": 6, "after": 6,
                 "scaled": 60}
# no client heartbeats in these runs: each server's heartbeat wheel is
# given a TTL floor of an hour, so the fleet stays up (the wheel runs)
CLUSTER_TTL_S = 3600.0
# how long a registration is retried through leadership churn
CLUSTER_RETRY_S = 120.0


def cluster_tune(cs) -> None:
    """What every booted server of a run gets before any node registers:
    the TTL floor, and (batch worker) batches of SERVER_BATCH."""
    cs.server.heartbeaters.min_ttl_s = CLUSTER_TTL_S
    w = getattr(cs.server, "tpu_worker", None)
    if w is not None:
        w.batch_size = SERVER_BATCH


def cluster_wait(cond, what: str, timeout_s: float) -> float:
    """Poll cond until it holds; the seconds it took."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout_s,
              f"cluster: {what} after {timeout_s} s")
        time.sleep(0.01)
    return time.perf_counter() - t0


def followers(cluster) -> list:
    lead = cluster.leader()
    return [cs for nid, cs in sorted(cluster.servers.items())
            if cs is not lead]


def live_count(state) -> int:
    from nomad_tpu_torch.state.store import TABLE_ALLOCS

    # a copy of the table's rows: the apply loop writes it meanwhile
    return sum(1 for a in list(state._tables[TABLE_ALLOCS].values())
               if not a.terminal_status())


def job_done(state, job_id: str, count: int) -> bool:
    """Every eval of the job complete and `count` of its allocs live."""
    evs = state.evals_by_job("default", job_id)
    return (bool(evs) and all(e.status == "complete" for e in evs)
            and sum(1 for a in state.allocs_by_job("default", job_id)
                    if not a.terminal_status()) == count)


def store_view(state) -> dict:
    """A replica's store, alloc for alloc (id, job, group, node,
    resources, desired and client status, indexes) and table for table
    (keys and table index), with the jobs and evals it holds."""
    allocs = []
    for a in state.allocs():
        r = a.comparable_resources()
        allocs.append((a.id, a.job_id, a.task_group, a.node_id, r.cpu,
                       r.memory_mb, r.disk_mb, a.desired_status,
                       a.client_status, a.create_index, a.modify_index))
    tables = {}
    for t in sorted(state._indexes):
        rows = state._tables.get(t, {})
        tables[t] = (state._indexes[t], sorted(map(repr, rows)))
    return {
        "allocs": sorted(allocs),
        "tables": tables,
        "jobs": sorted((j.namespace, j.id, j.version, j.modify_index,
                        j.stop) for j in state.jobs()),
        "evals": sorted((e.id, e.job_id, e.status, e.modify_index)
                        for e in state.evals()),
        "nodes": sorted((n.id, n.status, n.modify_index)
                        for n in state.nodes()),
    }


def cluster_outcome(state) -> dict:
    """What a run's end state must show whatever its ids and raft
    indexes: placements (job, group, node) with their counts, eval
    outcomes and job versions."""
    placed: dict = {}
    for a in state.allocs():
        if not a.terminal_status():
            key = (a.job_id, a.task_group, a.node_id)
            placed[key] = placed.get(key, 0) + 1
    return {
        "placed": sorted(placed.items()),
        "evals": sorted(
            (e.job_id, e.triggered_by, e.status,
             tuple(sorted((e.queued_allocations or {}).items())))
            for e in state.evals()),
        "versions": sorted((j.id, j.version) for j in state.jobs()),
    }


# errors of a write that met leadership churn on its way: a leaderless
# window, an election, or a leader deposed while the entry replicated
CHURN_ERRORS = ("NotLeaderError", "LeadershipLostError", "no cluster leader")


def register_through(pool, cluster, method: str, args: dict, k: int = 0,
                     retried=None) -> object:
    """A Node or Job register sent over the fabric to a follower (the
    k-th, or the leader when none is left), retried through leadership
    churn as the reference's chaos scenarios retry it: a node or job
    registered again is an upsert. Each retry's error goes to
    `retried`; any other error raises."""
    from nomad_tpu_torch.rpc import RPCError

    deadline = time.monotonic() + CLUSTER_RETRY_S
    while True:
        fols = followers(cluster)
        target = fols[k % len(fols)] if fols else cluster.leader()
        try:
            return pool.call(target.addr, method, args, timeout_s=60.0)
        except (RPCError, ConnectionError, TimeoutError) as e:
            if isinstance(e, RPCError) and not any(
                    c in str(e) for c in CHURN_ERRORS):
                raise
            check(time.monotonic() < deadline,
                  f"cluster: {method} failed through churn: {e!r}")
            if retried is not None:
                retried.append(type(e).__name__)
            time.sleep(0.2)


def cluster_lockstep(boot, make, nodes: list, cfg=CLUSTER_SMALL) -> dict:
    """CLUSTER_SMALL on a three-server cluster, one eval at a time.

    boot() returns a started three-server ChaosCluster and a ConnPool of
    one package (the tests hand nomad_tpu's to the same function); make
    builds a job of that package. Every node and job goes through a
    follower's endpoint over the fabric, and each job's eval completes
    before the next job is registered, so each batch holds one eval and
    the placements are deterministic. At a quiet point the leader is
    killed; the next jobs go through the surviving follower; the killed
    server restarts from its data dir and catches up; job 0 is scaled
    up. Every server's store must then be equal, alloc for alloc and
    table for table; the run returns the placements, eval outcomes and
    job versions (cluster_outcome) and what happened."""
    cluster, pool = boot()
    try:
        for cs in cluster.servers.values():
            cluster_tune(cs)
        check(cluster.wait_for_stable_leader(60) is not None,
              "lockstep: no leader")
        for n in nodes:
            register_through(pool, cluster, "Node.register", {"node": n})
        cluster_wait(lambda: all(len(cs.server.state.nodes()) == len(nodes)
                                 for cs in cluster.servers.values()),
                     "lockstep: the fleet did not replicate", 60)
        count = cfg["count"]

        def run(job, want):
            register_through(pool, cluster, "Job.register", {"job": job})
            cluster.acked_jobs.add(job.id)
            cluster_wait(lambda: (cluster.leader() is not None and job_done(
                cluster.leader().server.state, job.id, want)),
                f"lockstep: job {job.id} not placed", 120)

        jobs = [make(f"lock-{j}", count)
                for j in range(cfg["before"] + cfg["after"])]
        for job in jobs[:cfg["before"]]:
            run(job, count)
        check(cluster.converged(60), "lockstep: no convergence before kill")
        killed = cluster.leader().node_id
        cluster.kill(killed)
        check(cluster.wait_for_stable_leader(60) is not None,
              "lockstep: no leader after the kill")
        for job in jobs[cfg["before"]:]:
            run(job, count)
        cluster.restart(killed)
        cluster_tune(cluster.servers[killed])
        check(cluster.wait_caught_up(killed, 120),
              "lockstep: the restarted server never caught up")
        scaled = make("lock-0", cfg["scaled"])
        run(scaled, cfg["scaled"])
        check(cluster.converged(60), "lockstep: no convergence at the end")
        cluster.check_invariants()
        views = {nid: store_view(cs.server.state)
                 for nid, cs in cluster.servers.items()}
        first = views[cluster.ids[0]]
        for nid, v in views.items():
            for key in first:
                check(v[key] == first[key],
                      f"lockstep: store of {nid} differs in {key}")
        lead = cluster.leader()
        out = cluster_outcome(lead.server.state)
        out["servers_compared"] = len(views)
        out["allocs_compared"] = len(first["allocs"])
        return out
    finally:
        cluster.shutdown()
        pool.shutdown()


class FrozenHeap:
    """The process's heap so far frozen out of the collector's passes
    while a cluster runs, as the reference's agent freezes its heap at
    startup (gctune.freeze_startup_heap): a pass stops every thread, the
    three in-process servers' heartbeats too, and a pass over what the
    earlier phases left takes longer than their election timeout."""

    def __enter__(self) -> "FrozenHeap":
        gc.collect()
        gc.freeze()
        return self

    def __exit__(self, *exc) -> None:
        gc.unfreeze()


def cluster_small(device: str, nodes: list) -> dict:
    """cluster_lockstep on the port's ChaosCluster, the batch worker on
    `device` with every solve on it (small_batch_threshold 0)."""
    import shutil
    import tempfile

    from nomad_tpu_torch.rpc import ConnPool
    from nomad_tpu_torch.testing.chaos import ChaosCluster

    root = tempfile.mkdtemp(prefix="cluster-lockstep-")

    def boot():
        cluster = ChaosCluster(
            3, root, scheduler_config=SchedulerConfig(
                device=device, small_batch_threshold=0),
            use_tpu_batch_worker=True)
        return cluster.start(), ConnPool()

    try:
        with FrozenHeap():
            return cluster_lockstep(boot, make_job,
                                    [n.copy() for n in nodes])
    finally:
        shutil.rmtree(root, ignore_errors=True)


class RaftClock:
    """Commit and apply times per raft index across a cluster's
    incarnations: wraps each RaftNode's commit advance and each FSM's
    apply on the instance. lag(lo, hi) is, over the entries in (lo, hi],
    the largest time from the leader's commit to the last live
    follower's apply."""

    def __init__(self) -> None:
        self.commit: dict = {}
        self.applied: dict = {}

    def watch(self, cs) -> None:
        raft, nid = cs.raft, cs.node_id
        applied = self.applied.setdefault(nid, {})
        real_adv, real_apply = raft._advance_commit_locked, raft.fsm.apply

        def advance():
            before = raft.commit_index
            real_adv()
            now = time.monotonic()
            for i in range(before + 1, raft.commit_index + 1):
                self.commit.setdefault(i, now)

        def apply(index, msg_type, payload):
            out = real_apply(index, msg_type, payload)
            applied[index] = time.monotonic()
            return out

        raft._advance_commit_locked = advance
        raft.fsm.apply = apply

    def lag(self, cluster, lo: int, hi: int) -> float:
        lead = cluster.leader()
        worst = 0.0
        for i in range(lo + 1, hi + 1):
            t = self.commit.get(i)
            if t is None:
                continue
            for nid in cluster.servers:
                if lead is not None and nid == lead.node_id:
                    continue
                a = self.applied.get(nid, {}).get(i)
                if a is not None:
                    worst = max(worst, a - t)
        return worst


class GcClock:
    """The cyclic collector's passes while installed (gc.callbacks):
    per generation, the count and the longest pass, and the seconds all
    passes took. A pass stops every thread of the process: all three
    servers of an in-process cluster at once."""

    def __init__(self) -> None:
        self._t0 = 0.0
        self.reset()
        gc.callbacks.append(self._cb)

    def reset(self) -> None:
        self.count = [0, 0, 0]
        self.max_s = [0.0, 0.0, 0.0]
        self.total_s = 0.0

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        dt = time.perf_counter() - self._t0
        g = info["generation"]
        self.count[g] += 1
        self.max_s[g] = max(self.max_s[g], dt)
        self.total_s += dt

    def read(self) -> dict:
        out = {"passes": list(self.count), "max_s": list(self.max_s),
               "total_s": self.total_s}
        self.reset()
        return out

    def remove(self) -> None:
        gc.callbacks.remove(self._cb)


class SyncLog:
    """Every ResidentClusterState.sync's outcome (last_sync), per
    resident instance, in call order; `total` counts them all. A
    compact batch syncs the worker's resident tensors once, just before
    its K1 launch."""

    def __init__(self) -> None:
        self.real = solver_mod.ResidentClusterState.sync
        self.by_resident: dict = {}
        self.total = 0
        log = self

        def sync(resident, *args, **kwargs):
            out = log.real(resident, *args, **kwargs)
            log.by_resident.setdefault(id(resident), []).append(
                resident.last_sync)
            log.total += 1
            return out

        solver_mod.ResidentClusterState.sync = sync

    def of(self, resident) -> list:
        return list(self.by_resident.get(id(resident), []))

    def restore(self) -> None:
        solver_mod.ResidentClusterState.sync = self.real


def log_entries(cluster, lo: int, hi: int) -> dict:
    """The leader's raft entries in (lo, hi]: count and payload bytes by
    type. An election nobody asked for (a collector pass stops every
    in-process server's heartbeats) is waited out, as the steps record
    such elections rather than fail on them."""
    lead = cluster.leader() or cluster.wait_for_stable_leader(60)
    check(lead is not None, "cluster: no leader to read the raft log of")
    raft = lead.raft
    out: dict = {}
    with raft._lock:
        entries = [e for e in raft._log if lo < e.index <= hi]
    for e in entries:
        n, b = out.get(e.msg_type, (0, 0))
        out[e.msg_type] = (n + 1, b + len(e.payload or b""))
    return {k: {"entries": n, "bytes": b} for k, (n, b) in out.items()}


def cluster_step(cluster, clock, m0, m1, l0, l1, lo, hi, wall, traces,
                 elections: int) -> dict:
    """One step's numbers: wall, every kernel's launches, leader changes
    (the process-wide counter: step-downs count too) and elections won,
    raft entries and bytes by type, raft apply count and sum, the
    AppendEntries calls (count, seconds, request bytes), replication
    lag, summed batch spans."""
    def count(name):
        return m1["counters"].get(name, 0) - m0["counters"].get(name, 0)

    def hist(name, key):
        return (m1["samples"].get(name, {}).get(key, 0)
                - m0["samples"].get(name, {}).get(key, 0))

    ae = "Raft.append_entries"
    return {
        "wall_s": wall,
        "launches": {k: l1[k] - l0[k] for k in l1},
        "leader_changes": count("nomad.raft.leader_changes"),
        "elections": elections,
        "failed_batches": count("nomad.worker.invoke.failed"),
        "churn_nacks": count("nomad.rpc.retry_count.worker.submit"),
        "raft_entries": log_entries(cluster, lo, hi),
        "raft_apply": {"count": hist("nomad.raft.apply_seconds", "count"),
                       "sum_s": hist("nomad.raft.apply_seconds", "sum")},
        "append_entries": {
            "calls": hist(f"nomad.rpc.call_seconds.{ae}", "count"),
            "sum_s": hist(f"nomad.rpc.call_seconds.{ae}", "sum"),
            "sent_bytes": count(f"nomad.rpc.sent_bytes.{ae}"),
            "served_s": hist(f"nomad.rpc.served_seconds.{ae}", "sum")},
        "max_replication_lag_s": clock.lag(cluster, lo, hi),
        "batches": len(traces),
        "compact_batches": sum(
            1 for t in traces
            if any(sp.name == "device.wait" for sp in t.spans)),
        "spans_ms": span_sums_ms(traces),
    }


def launch_counts() -> dict:
    """Every kernel wrapper's launches (K1-K7, each kernel of the
    kernels line) since tk.reset_launch_counts(), and K2's launches that
    were not donated under "scatter_rows_copy"."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out = {name: getattr(tk, name).launches for name in SOURCES}
    out["scatter_rows_copy"] = tk.scatter_rows.launches_copy
    return out


def worker_threads() -> set:
    return {t for t in threading.enumerate() if t.is_alive()
            and t.name in ("tpu-batch-solve", "tpu-batch-commit")}


def cluster_scenario(device: str, cfg: dict, on_step) -> dict:
    """The cluster phase (CLUSTER) on three ClusterServers with the GPU
    batch worker on `device`, batches of SERVER_BATCH, pipelined:
    cluster.setup, .c2m, .failover, .restart (module docstring, phase
    10). Launch counters zeroed just before c2m's first register and
    read after the failover's last placement."""
    import shutil
    import tempfile

    from nomad_tpu_torch import codec, metrics
    from nomad_tpu_torch.metrics import Registry
    from nomad_tpu_torch.rpc import ConnPool
    from nomad_tpu_torch.rpc.wire import MAX_FRAME
    from nomad_tpu_torch.testing.chaos import ChaosCluster

    metrics._install_registry(Registry())
    trace.clear_finished()
    threads_before = worker_threads()
    root = tempfile.mkdtemp(prefix="cluster-c2m-")
    cluster = ChaosCluster(
        3, root, scheduler_config=SchedulerConfig(device=device),
        use_tpu_batch_worker=True)
    pool = ConnPool()
    clock, syncs, gcs = RaftClock(), SyncLog(), GcClock()
    established: dict = {}
    retried: list = []  # registrations retried through churn, this step
    steps: dict = {}
    out = {"steps": steps}
    n_nodes, count, n_jobs = cfg["nodes"], cfg["count"], cfg["jobs"]
    half = n_jobs // 2

    def watch(cs):
        cluster_tune(cs)
        clock.watch(cs)
        real = cs.server.establish_leadership

        def establish():
            t0 = time.monotonic()
            real()
            established[cs.node_id] = (t0, time.monotonic())

        cs.server.establish_leadership = establish

    def mark():
        lead = cluster.leader()
        return (metrics.snapshot(), launch_counts(),
                lead.raft.last_index if lead else 0, time.perf_counter(),
                cluster.total_elections(), syncs.total)

    def step(name, t_mark, **extra):
        m0, l0, lo, t0, e0, y0 = t_mark
        m1, l1, hi, t1, e1, y1 = mark()
        traces = batch_traces()
        trace.clear_finished()
        s = cluster_step(cluster, clock, m0, m1, l0, l1, lo, hi, t1 - t0,
                         traces, e1 - e0)
        s["resident_syncs"] = y1 - y0
        s["register_retries"] = len(retried)
        retried.clear()
        s["gc"] = gcs.read()
        s.update(extra)
        steps[name] = s
        on_step(f"cluster.{name}", s["wall_s"],
                **{k: v for k, v in s.items() if k != "wall_s"})

    def all_live(want, servers, timeout_s):
        return cluster_wait(
            lambda: all(live_count(cs.server.state) == want
                        for cs in servers),
            f"the stores never held {want} live allocs", timeout_s)

    try:
        # cluster.setup
        t_setup = (metrics.snapshot(), launch_counts(), 0,
                   time.perf_counter(), 0, 0)
        cluster.start()
        for cs in cluster.servers.values():
            watch(cs)
        lead = cluster.wait_for_stable_leader(120)
        check(lead is not None, "cluster: no leader at boot")
        elect_s = time.perf_counter() - t_setup[3]
        nodes = c2m_nodes(n_nodes)
        errors = []

        def register(k):
            try:
                for n in nodes[k::cfg["threads"]]:
                    register_through(pool, cluster, "Node.register",
                                     {"node": n}, k=k, retried=retried)
            except Exception as e:  # surfaced by the check below
                errors.append(repr(e))

        t_reg = time.perf_counter()
        ts = [threading.Thread(target=register, args=(k,))
              for k in range(cfg["threads"])]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        check(not errors, f"cluster: node registration failed: {errors[:3]}")
        reg_s = time.perf_counter() - t_reg
        cluster_wait(lambda: all(len(cs.server.state.nodes()) == n_nodes
                                 for cs in cluster.servers.values()),
                     "the fleet did not replicate", 300)
        step("setup", t_setup, elect_s=elect_s, register_s=reg_s,
             leader=cluster.leader().node_id)

        # cluster.c2m: the first half of c2m's jobs through a follower
        jobs = [make_job(f"cl-{j}", count) for j in range(n_jobs)]
        tk.reset_launch_counts()
        t_c2m = mark()
        for job in jobs[:half]:
            register_through(pool, cluster, "Job.register", {"job": job},
                             retried=retried)
            cluster.acked_jobs.add(job.id)
        all_live(half * count, cluster.servers.values(), 900)
        wall = time.perf_counter() - t_c2m[3]
        lead = cluster.leader()
        step("c2m", t_c2m, jobs_per_s=half / wall,
             allocs_per_s=half * count / wall, leader=lead.node_id)
        old_res = lead.server.tpu_worker._resident

        # cluster.failover: kill the leader, the other half through the
        # surviving follower
        t_fo = mark()
        t_kill = time.monotonic()
        killed = lead.node_id
        cluster.kill(killed)
        kill_s = time.monotonic() - t_kill
        new_lead = None

        def elected():
            nonlocal new_lead
            new_lead = cluster.leader()
            return new_lead is not None

        cluster_wait(elected, "no leader after the kill", 120)
        cluster_wait(lambda: established.get(new_lead.node_id,
                                             (0.0, 0.0))[0] > t_kill,
                     "the new leader never finished establish_leadership",
                     120)
        # elected: its leader-change callback began establish_leadership
        # (the replay barrier first); established: the callback returned
        to_leader = established[new_lead.node_id][0] - t_kill
        to_established = established[new_lead.node_id][1] - t_kill
        for job in jobs[half:]:
            register_through(pool, cluster, "Job.register", {"job": job},
                             retried=retried)
            cluster.acked_jobs.add(job.id)
        all_live(n_jobs * count, cluster.servers.values(), 900)
        out["launches"] = launch_counts()
        new_res = new_lead.server.tpu_worker._resident
        new_syncs = syncs.of(new_res)
        step("failover", t_fo, killed=killed, leader=new_lead.node_id,
             kill_s=kill_s, to_leader_s=to_leader,
             to_established_s=to_established,
             new_leader_syncs=new_syncs[:3] + (
                 [f"... {len(new_syncs)} syncs"] if len(new_syncs) > 3
                 else []))
        out["new_leader_syncs"] = new_syncs
        out["resident"] = (old_res, new_res)

        # cluster.restart: the killed server from its data dir
        t_rs = mark()
        cs = cluster.restart(killed)
        watch(cs)
        with cs.raft._lock:
            replayed = len(cs.raft._log)
        caught = cluster.wait_caught_up(killed, 600)
        check(caught, "cluster: the restarted server never caught up")
        caught_s = time.perf_counter() - t_rs[3]
        check(cluster.converged(300), "cluster: no convergence after restart")
        t_cmp = time.perf_counter()
        views = {nid: store_view(s.server.state)
                 for nid, s in cluster.servers.items()}
        first = views[cluster.ids[0]]
        for nid, v in views.items():
            for key in first:
                check(v[key] == first[key],
                      f"cluster: the store of {nid} differs in {key}")
        compare_s = time.perf_counter() - t_cmp
        step("restart", t_rs, restarted=killed, replayed_entries=replayed,
             caught_up_s=caught_s, compare_s=compare_s,
             allocs_compared=len(first["allocs"]), servers=len(views),
             terms={nid: s.raft.current_term
                    for nid, s in sorted(cluster.servers.items())})

        # the checks over the whole run; an election nobody asked for
        # (a collector pass stops every server's heartbeats) is waited
        # out, as log_entries waits it out
        cluster.check_invariants()
        lead = cluster.leader() or cluster.wait_for_stable_leader(60)
        check(lead is not None, "cluster: no leader after the restart")
        check_server_state(lead.server, n_jobs * count)
        c = metrics.snapshot()["counters"]
        check(c.get("nomad.worker.device_failover", 0) == 0,
              "cluster: a device failover")
        # a batch whose commit met a deposed leader (NotLeaderError)
        # nacks and redelivers to the next leader: the churn path, which
        # the worker counts apart; any other failed batch fails the run
        failed = (c.get("nomad.worker.invoke.failed", 0)
                  - c.get("nomad.rpc.retry_count.worker.submit", 0))
        check(failed == 0,
              f"cluster: {failed} batches failed to solve or commit")
        check(all(s.raft._snap_last_index == 0
                  for s in cluster.servers.values()),
              "cluster: a raft log compacted")
        out["log_entries"] = lead.raft.last_index
        out["snapshot"] = snapshot_sample(lead.server.state, SNAPSHOT,
                                          MAX_FRAME)
        out["fastpack_live"] = codec.native_module() is not None
    finally:
        syncs.restore()
        gcs.remove()
        t0 = time.perf_counter()
        cluster.shutdown()
        pool.shutdown()
        out["shutdown_s"] = time.perf_counter() - t0
        shutil.rmtree(root, ignore_errors=True)
    out["leaked_workers"] = sorted(t.name for t in
                                   worker_threads() - threads_before)
    return out


# serialize() is timed on a store cut to 2,000 nodes and 20 jobs: the
# whole c2m store's took 88-115 s of a run, and scripts/snapshot_bytes.py's
# defaults (4,000 nodes and 40 jobs) 62 s of one with the fleet, soak and
# scenario phases beside it, so the cut keeps the run's time
SNAPSHOT = {"nodes": 2000, "jobs": 20}


def snapshot_sample(state, cut: dict, max_frame: int) -> dict:
    """StateStore.serialize() bytes and seconds for a fresh store holding
    the first cut["nodes"] of `state`'s nodes, its first cut["jobs"]
    jobs and their allocs on those nodes (a number to record)."""
    from nomad_tpu_torch.state import StateStore

    nodes = [n.copy() for n in state.nodes()[:cut["nodes"]]]
    jobs = [j.copy() for j in state.jobs()[:cut["jobs"]]]
    keep_nodes = {n.id for n in nodes}
    keep_jobs = {j.id for j in jobs}
    allocs = [a.copy() for a in state.allocs()
              if a.node_id in keep_nodes and a.job_id in keep_jobs]
    store = StateStore()
    index = 1
    for n in nodes:
        store.upsert_node(index, n)
        index += 1
    for j in jobs:
        store.upsert_job(index, j)
        index += 1
    for i in range(0, len(allocs), 1000):
        store.upsert_allocs(index, allocs[i:i + 1000])
        index += 1
    t0 = time.perf_counter()
    raw = store.serialize()
    return {"nodes": len(nodes), "jobs": len(jobs), "allocs": len(allocs),
            "bytes": len(raw),
            "seconds": time.perf_counter() - t0, "max_frame": max_frame}


def check_cluster_run(res) -> None:
    """K1 on the card before and after the failover, once for every
    compact solve (every sync of a worker's resident tensors) in each
    step, the new leader's first sync a full upload and then K2
    donated, both leaders' resident tensors on cuda:0, no worker thread
    left after shutdown. (A step's batch traces can straddle its end:
    a trace finishes after its batch's allocs are counted.)"""
    steps = res["steps"]
    for name in ("c2m", "failover"):
        s = steps[name]
        k1 = s["launches"]["solve_placement_compact"]
        check(s["resident_syncs"] > 0 and k1 >= s["resident_syncs"],
              f"cluster.{name}: K1 ran {k1} times for "
              f"{s['resident_syncs']} compact solves")
    syncs = res["new_leader_syncs"]
    check(syncs and syncs[0] == "full",
          f"cluster: the new leader's first sync was {syncs[:1]}")
    check(any(s.startswith("delta:") for s in syncs[1:]),
          "cluster: the new leader made no delta sync")
    check(steps["failover"]["launches"]["scatter_rows"] >= 1,
          "cluster.failover: K2 donated was not launched")
    cuda0 = torch.device("cuda", 0)
    for r in res["resident"]:
        check(r is not None and r._cap_dev.device == cuda0
              and r._used_dev.device == cuda0,
              "cluster: a leader's resident tensors are not on cuda:0")
    check(res["fastpack_live"], "cluster: the C fastpack did not load")
    check(not res["leaked_workers"],
          f"cluster: worker threads left after shutdown: "
          f"{res['leaked_workers']}")


# ---------------------------------------------------------------------------
# the operator's front door: a server agent with its HTTP API, c2m's jobs
# as HCL through the CLI's `job run`, an operator's reads over HTTP
# ---------------------------------------------------------------------------

# the agent phase at c2m's width: the fleet through the agent's fabric
# from 32 threads (as cluster.setup registers it), 100 jobs of 1,000
# read_jobs: the jobs whose allocs agent.read reads back over HTTP (all
# 100 until the client phase came; cut to keep the run's time)
AGENT = {"nodes": 10000, "jobs": 100, "count": 1000, "threads": 32,
         "read_jobs": 20}
# agent_lockstep's size: 200 nodes, six jobs of 50, each eval complete
# before the next job is submitted
AGENT_SMALL = {"nodes": 200, "jobs": 6, "count": 50}
# the reads agent_lockstep compares, per job and once for the run
AGENT_JOB_READS = ("/v1/job/{id}", "/v1/job/{id}/allocations",
                   "/v1/job/{id}/summary", "/v1/job/{id}/evaluations",
                   "/v1/job/{id}/versions")
AGENT_READS = ("/v1/jobs", "/v1/nodes", "/v1/allocations",
               "/v1/evaluations", "/v1/deployments")
# c2m's job (bench.py add_jobs, make_job) as an operator writes it
C2M_HCL = """job "{id}" {{
  datacenters = ["dc1", "dc2", "dc3", "dc4"]

  constraint {{
    attribute = "${{attr.kernel.name}}"
    value     = "linux"
  }}

  spread {{
    attribute = "${{node.datacenter}}"
    weight    = 50
  }}

  group "web" {{
    count = {count}

    task "web" {{
      driver = "exec"

      resources {{
        cpu    = 250
        memory = 128
      }}
    }}
  }}
}}
"""
# the providers /v1/metrics must carry, each with the key it is read by
AGENT_PROVIDERS = {"nomad.broker": "total_ready",
                   "nomad.plan_queue": "depth",
                   "nomad.workers": "processed",
                   "nomad.fleet": "nodes_ready"}


def write_jobs(root: str, n_jobs: int, count: int, prefix: str) -> list:
    """One HCL jobfile per job under root: [(job id, path)]."""
    import os

    out = []
    for j in range(n_jobs):
        job_id = f"{prefix}-{j}"
        path = os.path.join(root, f"{job_id}.nomad")
        with open(path, "w") as f:
            f.write(C2M_HCL.format(id=job_id, count=count))
        out.append((job_id, path))
    return out


def run_cli(cli_main, *argv) -> tuple:
    """A CLI command in this process: (exit code, its standard output,
    seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(list(argv))
    return rc, buf.getvalue(), time.perf_counter() - t0


def submitted_eval(out: str) -> str:
    m = re.search(r"Evaluation ID: (\S+)", out)
    check(m is not None, f"job run printed no evaluation id: {out!r}")
    return m.group(1)


def start_agent(device: str, data_dir: str, every_solve: bool = False):
    """The port's server agent (nomad_tpu_torch.agent): the GPU batch
    worker on `device` in batches of SERVER_BATCH (every_solve: with
    small_batch_threshold 0, so no batch takes the host route), a
    durable raft log under data_dir, the heartbeat TTL floor an hour (no
    client runs); returns it once its server leads and its leadership is
    established."""
    from nomad_tpu_torch.agent import Agent, AgentConfig

    agent = Agent(AgentConfig(
        server_enabled=True, use_tpu_batch_worker=True, device=device,
        data_dir=data_dir, node_name="agent-0"))
    if every_solve:
        agent.server.server.scheduler_config.small_batch_threshold = 0
    cluster_tune(agent.server)
    agent.start()
    cluster_wait(lambda: agent.server.is_leader()
                 and agent.server.server._leader,
                 "agent: no established leader", 120)
    return agent


def register_fleet(pool, addr, nodes: list, threads: int, what: str):
    """Every node through Node.register at addr over the fabric, from
    `threads` threads; a failed registration fails the check."""
    errors = []

    def register(k):
        try:
            for n in nodes[k::threads]:
                pool.call(addr, "Node.register", {"node": n}, timeout_s=60.0)
        except Exception as e:  # surfaced by the check below
            errors.append(repr(e))

    ts = [threading.Thread(target=register, args=(k,))
          for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    check(not errors, f"{what}: node registration failed: {errors[:3]}")


def live_threads() -> set:
    return {t for t in threading.enumerate() if t.is_alive()}


class EventCounter:
    """One /v1/event/stream subscriber (Job and Allocation topics) on a
    thread of its own: counts the frames' events by (topic, type), the
    payloads left undecoded. `ended` says the server ended the stream
    before close(): a subscriber whose cursor falls off the broker's
    ring is closed (SubscriptionClosedError), as in the reference."""

    def __init__(self, addr: str) -> None:
        import http.client
        import socket
        import urllib.parse

        self.counts: dict = {}
        self.frames = 0
        self.error = None
        self.ended = False
        url = urllib.parse.urlparse(addr)
        # the socket is kept so close() can end a read blocked on it
        self.sock = socket.create_connection((url.hostname, url.port),
                                             timeout=600)
        self.sock.sendall(
            b"GET /v1/event/stream?topic=Job:*&topic=Allocation:* "
            b"HTTP/1.1\r\nHost: agent\r\n\r\n")
        self.resp = http.client.HTTPResponse(self.sock)
        self.resp.begin()
        self.thread = threading.Thread(target=self._run,
                                       name="agent-events", daemon=True)
        self.thread.start()

    def _run(self) -> None:
        try:
            for line in self.resp:
                line = line.strip()
                if not line or line == b"{}":
                    continue
                frame = json.loads(line)
                self.frames += 1
                for ev in frame.get("Events", ()):
                    key = f"{ev['Topic']}.{ev['Type']}"
                    self.counts[key] = self.counts.get(key, 0) + 1
            self.ended = True
        except Exception as e:  # the stream ends with close()
            self.error = f"{type(e).__name__}: {e}"

    def close(self) -> None:
        """Disconnect: the agent's stream handler sees the peer gone at
        its next liveness probe (an agent's shutdown does not end an open
        stream, as in nomad_tpu)."""
        import socket

        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.thread.join(30)
        self.sock.close()


def wait_evals_http(api, state, eval_ids: list, timeout_s: float) -> dict:
    """Wait until every eval in eval_ids is complete, through blocking
    queries on /v1/evaluations?index=: each returns when the evals
    table moves past the index it was given. The store is polled too,
    so an eval sitting out the broker's nack delay (whose table does not
    move) is seen once it completes. Returns the blocking queries made
    and their seconds."""
    want = set(eval_ids)
    index, queries, spent = 0, 0, 0.0
    deadline = time.monotonic() + timeout_s
    while True:
        t0 = time.perf_counter()
        evals, index = api.get_with_index(
            "/v1/evaluations", params={"index": index, "wait": "2s"})
        spent += time.perf_counter() - t0
        queries += 1
        done = {e.id for e in evals if e.id in want
                and e.status == "complete"}
        if done == want or all(state.eval_by_id(i).status == "complete"
                               for i in want):
            return {"blocking_queries": queries, "blocking_s": spent}
        check(time.monotonic() < deadline,
              f"agent: evals not complete after {timeout_s} s")


def metric_gauges(snap: dict) -> dict:
    return {p: {k[len(p) + 1:]: v for k, v in snap["gauges"].items()
                if k.startswith(p + ".")} for p in AGENT_PROVIDERS}


def agent_scenario(device: str, cfg: dict, on_step) -> dict:
    """The agent phase (AGENT) on one server agent with the GPU batch
    worker on `device`: agent.setup, agent.c2m, agent.read (module
    docstring, phase 11). Launch counters zeroed just before the first
    job plan and read after the last eval completes."""
    import shutil
    import tempfile

    from nomad_tpu_torch import codec, metrics, solverobs
    from nomad_tpu_torch.api import NomadClient
    from nomad_tpu_torch.cli.main import main as cli_main
    from nomad_tpu_torch.metrics import Registry
    from nomad_tpu_torch.rpc import ConnPool
    from nomad_tpu_torch.solverobs import SolverObservatory

    metrics._install_registry(Registry())
    solverobs._install(SolverObservatory())
    trace.clear_finished()
    threads_before = live_threads()
    root = tempfile.mkdtemp(prefix="agent-c2m-")
    syncs = SyncLog()
    out: dict = {"steps": {}}
    steps = out["steps"]
    n_nodes, count, n_jobs = cfg["nodes"], cfg["count"], cfg["jobs"]
    pool = ConnPool()
    agent = events = None
    try:
        # agent.setup
        t0 = time.perf_counter()
        agent = start_agent(device, root + "/data")
        lead_s = time.perf_counter() - t0
        srv = agent.server.server
        addr = "http://{}:{}".format(*agent.http_addr)
        api = NomadClient(addr)
        t_reg = time.perf_counter()
        register_fleet(pool, agent.server.addr, c2m_nodes(n_nodes),
                       cfg["threads"], "agent")
        cluster_wait(lambda: len(srv.state.nodes()) == n_nodes,
                     "agent: the fleet did not register", 300)
        reg_s = time.perf_counter() - t_reg
        steps["setup"] = {"wall_s": time.perf_counter() - t0,
                          "leader_s": lead_s, "register_s": reg_s,
                          "nodes": len(srv.state.nodes())}
        on_step("agent.setup", steps["setup"]["wall_s"],
                **{k: v for k, v in steps["setup"].items()
                   if k != "wall_s"})

        # agent.c2m: one job plan, then every job through `job run`
        jobs = write_jobs(root, n_jobs, count, "ag")
        events = EventCounter(addr)
        tk.reset_launch_counts()
        m0, y0 = metrics.snapshot(), syncs.total
        plan_rc, plan_out, plan_s = run_cli(
            cli_main, "-address", addr, "job", "plan", jobs[0][1])
        check(plan_rc == 1, f"agent: job plan exited {plan_rc}, want 1 "
              f"(changes): {plan_out[-500:]!r}")
        check(f"({count} create)" in plan_out,
              f"agent: job plan did not report {count} creates")
        t_c2m = time.perf_counter()
        eval_ids, cli_s = [], 0.0
        for job_id, path in jobs:
            rc, text, secs = run_cli(cli_main, "-address", addr, "job",
                                     "run", "-detach", path)
            check(rc == 0, f"agent: job run {job_id} exited {rc}")
            eval_ids.append(submitted_eval(text))
            cli_s += secs
        submit_s = time.perf_counter() - t_c2m
        waited = wait_evals_http(api, srv.state, eval_ids, 900)
        wall = time.perf_counter() - t_c2m
        out["launches"] = launch_counts()
        m1 = metrics.snapshot()
        traces = batch_traces()
        trace.clear_finished()
        c2m = wave_numbers(m0, m1, traces, wall, n_jobs, n_jobs * count)
        c2m.update(waited, plan_rc=plan_rc, plan_ms=1e3 * plan_s,
                   submit_s=submit_s, cli_ms_per_job=1e3 * cli_s / n_jobs,
                   launches=out["launches"],
                   resident_syncs=syncs.total - y0)
        steps["c2m"] = c2m
        on_step("agent.c2m", wall,
                **{k: v for k, v in c2m.items() if k != "wall_s"})
        check_server_state(srv, n_jobs * count)
        out["counters"] = m1["counters"]
        out["eval_ids"] = eval_ids

        # agent.read: an operator's reads
        t_read = time.perf_counter()
        rc, text, st_s = run_cli(cli_main, "-address", addr, "job",
                                 "status", jobs[0][0])
        check(rc == 0 and "Allocations" in text,
              f"agent: job status exited {rc}")
        # the first read_jobs jobs' allocs over HTTP, compared with the
        # store on the JSON; the first job's also decoded into structs as the SDK's
        # jobs.allocations() does (timed: the client's share)
        http_bytes, http_s, allocs_read = 0, 0.0, 0
        decode_s = decoded = None
        for job_id, _ in jobs[:cfg["read_jobs"]]:
            t0 = time.perf_counter()
            resp = api.get(f"/v1/job/{job_id}/allocations", raw=True)
            raw = resp.read()
            http_s += time.perf_counter() - t0
            http_bytes += len(raw)
            got = json.loads(raw)
            if decode_s is None:
                t0 = time.perf_counter()
                decoded = len(codec.from_wire(got))
                decode_s = time.perf_counter() - t0
            allocs_read += len(got)
            want = {(a.id, a.node_id, a.name, a.desired_status,
                     a.client_status) for a in srv.state.allocs_by_job(
                         "default", job_id)}
            check({(a["id"], a["node_id"], a["name"], a["desired_status"],
                    a["client_status"]) for a in got} == want,
                  f"agent: the allocs of {job_id} read over HTTP differ "
                  "from the store")
        # the CLI's own cost on the quiet agent: building its parser
        # (`version`) and parsing one c2m jobfile, medians of 5
        with open(jobs[0][1]) as f:
            hcl = f.read()
        from nomad_tpu_torch.jobspec import parse_job

        version_ms = 1e3 * statistics.median(
            run_cli(cli_main, "version")[2] for _ in range(5))
        parse_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            parse_job(hcl)
            parse_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        snap = api.agent.metrics()
        metrics_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        prom = api.agent.metrics_prometheus()
        prom_s = time.perf_counter() - t0
        gauges = metric_gauges(snap)
        rc, solver_text, solver_s = run_cli(cli_main, "-address", addr,
                                            "operator", "solver", "status")
        check(rc == 0, f"agent: operator solver status exited {rc}")
        ledger = api.agent.solver_status()
        read = {"job_status_ms": 1e3 * st_s, "allocs_read": allocs_read,
                "allocs_bytes": http_bytes, "allocs_http_s": http_s,
                "allocs_decoded": decoded, "allocs_decode_s": decode_s,
                "cli_version_ms": version_ms,
                "hcl_parse_ms": statistics.median(parse_ms),
                "metrics_ms": 1e3 * metrics_s, "prometheus_ms": 1e3 * prom_s,
                "prometheus_bytes": len(prom.encode()),
                "solver_status_ms": 1e3 * solver_s,
                "providers": {p: {k: v for k, v in g.items()
                                  if k == AGENT_PROVIDERS[p]}
                              for p, g in gauges.items()},
                "events": dict(sorted(events.counts.items())),
                "event_frames": events.frames,
                "event_stream_closed_by_server": events.ended}
        steps["read"] = read
        on_step("agent.read", time.perf_counter() - t_read,
                **{k: v for k, v in read.items()})
        out.update(gauges=gauges, prom=prom, solver_text=solver_text,
                   ledger=ledger, allocs_read=allocs_read,
                   events=dict(events.counts))
        out["resident"] = srv.tpu_worker._resident
        out["fastpack_live"] = codec.native_module() is not None
    finally:
        syncs.restore()
        t0 = time.perf_counter()
        if agent is not None:
            agent.shutdown()
        if events is not None:
            events.close()
        pool.shutdown()
        out["shutdown_s"] = time.perf_counter() - t0
        shutil.rmtree(root, ignore_errors=True)
    # every thread the phase started ends with the agent: the batch
    # worker's, the HTTP listener's and its handlers', the leader's
    # watchers, the fabric's (an HTTP handler of a stream may take a
    # moment to see its socket close)
    deadline = time.monotonic() + 30
    while live_threads() - threads_before and time.monotonic() < deadline:
        time.sleep(0.1)
    out["leaked_threads"] = sorted(t.name for t in
                                   live_threads() - threads_before)
    return out


def check_agent_run(res) -> None:
    """Every eval complete with its 100,000 allocs (checked in the run),
    no device failover or failed batch, K1 once for every compact solve
    and its resident tensors on cuda:0, the providers on /v1/metrics
    with live values, the solver status showing K1's launches, and no
    thread of the agent left after its shutdown. The event subscriber's
    counts are numbers to record: a subscriber that falls off the
    broker's ring is closed, and whether it does depends on its pace."""
    c = res["counters"]
    check(c.get("nomad.worker.device_failover", 0) == 0,
          "agent: a device failover")
    check(c.get("nomad.worker.invoke.failed", 0) == 0,
          "agent: a batch failed to solve or commit")
    s = res["steps"]["c2m"]
    k1 = s["launches"]["solve_placement_compact"]
    check(s["resident_syncs"] > 0 and k1 >= s["resident_syncs"],
          f"agent: K1 ran {k1} times for {s['resident_syncs']} compact "
          "solves")
    cuda0 = torch.device("cuda", 0)
    r = res["resident"]
    check(r is not None and r._cap_dev.device == cuda0
          and r._used_dev.device == cuda0,
          "agent: the worker's resident tensors are not on cuda:0")
    check(res["fastpack_live"], "agent: the C fastpack did not load")
    g = res["gauges"]
    check(all(g[p] for p in AGENT_PROVIDERS),
          f"agent: /v1/metrics lacks providers: "
          f"{[p for p in AGENT_PROVIDERS if not g[p]]}")
    n_nodes, n_jobs = AGENT["nodes"], AGENT["jobs"]
    check(g["nomad.fleet"].get("nodes_ready") == n_nodes,
          f"agent: nomad.fleet.nodes_ready is "
          f"{g['nomad.fleet'].get('nodes_ready')}, want {n_nodes}")
    check(res["allocs_read"] == AGENT["read_jobs"] * AGENT["count"],
          f"agent: {res['allocs_read']} allocs read over HTTP")
    check(g["nomad.workers"].get("processed", 0) >= n_jobs,
          "agent: nomad.workers.processed counts fewer evals than jobs")
    check(g["nomad.plan_queue"].get("depth") == 0,
          "agent: the plan queue is not empty after the run")
    for p in AGENT_PROVIDERS:
        prom_name = p.replace(".", "_")
        check(prom_name in res["prom"],
              f"agent: the Prometheus text lacks {prom_name}")
    kl = res["ledger"]["ledger"]["kernels"].get("solve_placement_compact")
    check(kl is not None and kl["launches"] >= k1,
          "agent: the solver status ledger lacks K1's launches")
    row = [ln for ln in res["solver_text"].splitlines()
           if ln.startswith("solve_placement_compact")]
    check(row and str(kl["launches"]) in row[0].split(),
          "agent: operator solver status does not show K1's launches")
    check(res["ledger"]["device_memory"] is not None,
          "agent: the solver status reports no card memory")
    check(not res["leaked_threads"],
          f"agent: threads left after shutdown: {res['leaked_threads']}")


def agent_names(state) -> dict:
    """Each id the server minted mapped to what names it: an alloc by
    its job and name, an eval by its job, trigger and order, a
    deployment by its job and version."""
    names = {a.id: f"alloc:{a.job_id}/{a.name}" for a in state.allocs()}
    seen: dict = {}
    for e in sorted(state.evals(), key=lambda e: e.create_index):
        k = seen[e.job_id] = seen.get(e.job_id, -1) + 1
        names[e.id] = f"eval:{e.job_id}/{e.triggered_by}/{k}"
    for d in state.deployments():
        names[d.id] = f"deployment:{d.job_id}/{d.job_version}"
    return names


# fields that differ between two runs of the same operations: raft
# indexes, wall-clock times and the nodes' heartbeat TTLs
_VOLATILE = re.compile(r"(^|_)(index|time|at|ttl|ns)$|^wait_until$")


def http_view(body, names: dict):
    """A response body with each minted id replaced by what names it,
    the volatile fields dropped, and lists of objects sorted."""
    if isinstance(body, dict):
        return {k: http_view(v, names) for k, v in body.items()
                if not _VOLATILE.search(k)}
    if isinstance(body, list):
        items = [http_view(v, names) for v in body]
        if items and all(isinstance(v, dict) for v in items):
            items.sort(key=lambda v: json.dumps(v, sort_keys=True))
        return items
    if isinstance(body, str):
        return names.get(body, body)
    return body


def agent_lockstep(boot, cli_main, nodes: list, cfg=AGENT_SMALL) -> dict:
    """AGENT_SMALL through one server agent, one eval at a time.

    boot() returns a started server agent (its batch worker in batches
    of SERVER_BATCH with every solve on its solver, small_batch_threshold
    0) and a ConnPool of one package; cli_main is that package's CLI
    (the tests hand nomad_tpu's to the same function). Every node
    registers over the agent's fabric; each job goes in as HCL through
    `job run -detach` and its eval completes before the next. Returns
    the placements (job, alloc name, node), the eval outcomes and the
    bodies of AGENT_JOB_READS and AGENT_READS (http_view)."""
    import shutil
    import tempfile
    import urllib.request

    root = tempfile.mkdtemp(prefix="agent-lockstep-")
    agent, pool = boot(root + "/data")
    try:
        srv = agent.server.server
        addr = "http://{}:{}".format(*agent.http_addr)
        for n in nodes:
            pool.call(agent.server.addr, "Node.register", {"node": n},
                      timeout_s=60.0)
        cluster_wait(lambda: len(srv.state.nodes()) == len(nodes),
                     "lockstep: the fleet did not register", 60)
        jobs = write_jobs(root, cfg["jobs"], cfg["count"], "lock")
        for job_id, path in jobs:
            rc, text, _ = run_cli(cli_main, "-address", addr, "job", "run",
                                  "-detach", path)
            check(rc == 0, f"lockstep: job run {job_id} exited {rc}")
            eval_id = submitted_eval(text)
            cluster_wait(lambda: srv.state.eval_by_id(eval_id).status
                         == "complete",
                         f"lockstep: the eval of {job_id} never completed",
                         120)
        cluster_wait(lambda: srv.eval_broker.inflight_count() == 0
                     and srv.plan_queue.depth() == 0,
                     "lockstep: the broker did not drain", 60)
        state = srv.state
        names = agent_names(state)
        reads = {}
        paths = [p.format(id=job_id) for job_id, _ in jobs
                 for p in AGENT_JOB_READS] + list(AGENT_READS)
        for path in paths:
            with urllib.request.urlopen(addr + path, timeout=60) as resp:
                reads[path] = http_view(json.loads(resp.read()), names)
        out = cluster_outcome(state)
        out["allocs"] = sorted((a.job_id, a.name, a.node_id)
                               for a in state.allocs()
                               if not a.terminal_status())
        out["reads"] = reads
        return out
    finally:
        agent.shutdown()
        pool.shutdown()
        shutil.rmtree(root, ignore_errors=True)


def agent_small(device: str, nodes: list) -> dict:
    """agent_lockstep on the port's server agent, the batch worker on
    `device` with every solve on it (small_batch_threshold 0)."""
    from nomad_tpu_torch.cli.main import main as cli_main
    from nomad_tpu_torch.rpc import ConnPool

    def boot(data_dir):
        return start_agent(device, data_dir, every_solve=True), ConnPool()

    return agent_lockstep(boot, cli_main, [n.copy() for n in nodes])


# ---------------------------------------------------------------------------
# the client: agents whose clients run tasks on this host
# ---------------------------------------------------------------------------

# The client phase: c2m's fleet plus four real nodes, the co-located
# client of a server agent (dc1) and three client agents (dc2-dc4);
# C2M's density, 2,000,000 containers on 6,100 hosts (BASELINE.md:11),
# is 330 allocs a host. The real nodes' capacity is pinned to the host's
# cores at 2,300 MHz and 12,288 MB each (below what the card machine's
# 8 cores fingerprint, 19,111-20,800 MHz and 103,424 MB), so that every
# run places the same count
CLIENT = {"nodes": 10000, "per_node": 330, "threads": 32, "exec_count": 4,
          "gpu": True, "core_mhz": 2300, "core_mb": 12288}
# client_lockstep's size: 200 simulated nodes, two real ones pinned to
# one capacity, two mock-driver jobs of 20 and one raw_exec task
CLIENT_SMALL = {"nodes": 200, "jobs": 2, "count": 20, "cpu": 16000,
                "memory": 16384}
CLIENT_DCS = ("dc1", "dc2", "dc3", "dc4")
# c2m's ask (make_job) and what each exec-job group's task asks
CLIENT_ASK = {"cpu": 250, "memory": 128}
EXEC_ASK = {"cpu": 100, "memory": 64}
# the real nodes' ids in client_lockstep (the same on both packages, so
# that ties between them break alike)
LOCK_NODE_IDS = ("00000000-0000-4000-8000-0000000000d1",
                 "00000000-0000-4000-8000-0000000000d2")
# c2m's job as an operator writes it for the real nodes: the mock driver
# running until stopped, an update stanza (a deployment tracks health)
# and a migrate stanza with a migrating ephemeral disk (a drain's
# replacements wait on their previous alloc through the allocwatcher)
CLIENT_HCL = """job "{id}" {{
  datacenters = [{dcs}]

  constraint {{
    attribute = "${{attr.kernel.name}}"
    value     = "linux"
  }}

  constraint {{
    attribute = "${{meta.real}}"
    value     = "1"
  }}

  spread {{
    attribute = "${{node.datacenter}}"
    weight    = 50
  }}

  update {{
    max_parallel     = 1
    min_healthy_time = "1s"
    healthy_deadline = "5m"
  }}

  group "web" {{
    count = {count}

    migrate {{
      max_parallel     = {migrate}
      min_healthy_time = "1s"
    }}

    ephemeral_disk {{
      migrate = true
    }}

    task "web" {{
      driver = "mock"

      resources {{
        cpu    = 250
        memory = 128
      }}
    }}
  }}
}}
"""
# one process task a real node, two groups: raw_exec printing the card
# it was given, and exec under the native executor
EXEC_HCL = """job "{id}" {{
  datacenters = [{dcs}]

  constraint {{
    attribute = "${{meta.real}}"
    value     = "1"
  }}

  group "dev" {{
    count = {count}

    constraint {{
      distinct_hosts = true
    }}

    task "dev" {{
      driver = "rawexec"

      config {{
        command = "/bin/sh"
        args    = ["-c", "echo dev=$CUDA_VISIBLE_DEVICES; sleep 600"]
      }}

      resources {{
        cpu    = 100
        memory = 64
{device}      }}
    }}
  }}

  group "box" {{
    count = {count}

    constraint {{
      distinct_hosts = true
    }}

    task "box" {{
      driver = "exec"

      config {{
        command = "/bin/sleep"
        args    = ["600"]
      }}

      resources {{
        cpu    = 100
        memory = 64
      }}
    }}
  }}
}}
"""
EXEC_DEVICE = """
        device "nvidia/gpu" {
          count = 1
        }
"""
# client_lockstep's process task
RAW_HCL = """job "{id}" {{
  datacenters = [{dcs}]

  constraint {{
    attribute = "${{meta.real}}"
    value     = "1"
  }}

  group "raw" {{
    count = 1

    task "raw" {{
      driver = "rawexec"

      config {{
        command = "/bin/sleep"
        args    = ["600"]
      }}

      resources {{
        cpu    = 100
        memory = 64
      }}
    }}
  }}
}}
"""


def hcl_dcs(dcs) -> str:
    return ", ".join(f'"{dc}"' for dc in dcs)


def write_hcl(root: str, job_id: str, text: str) -> str:
    import os

    path = os.path.join(root, f"{job_id}.nomad")
    with open(path, "w") as f:
        f.write(text)
    return path


def start_real_agent(agent_mod, data_dir: str, dc: str, *, servers=None,
                     device=None, dev_mode: bool = False,
                     every_solve: bool = False, node_id=None,
                     capacity=None):
    """An agent whose client runs tasks on this host, of either package
    (agent_mod is its agent module): with servers None, a server with a
    co-located client (`agent -dev`'s shape; dev_mode keeps its raft log
    in memory), its batch worker in batches of SERVER_BATCH (every_solve:
    small_batch_threshold 0) and its heartbeat TTL floor an hour
    (cluster_tune: the simulated nodes send no heartbeats); else a client
    agent whose servers are `servers`. Its node is named real-<dc> and
    carries meta real = "1"; node_id and capacity ((MHz, MB)) pin its id
    and resources (client_lockstep: the same on both packages). Started;
    a server agent is returned once it leads."""
    import importlib

    kw = dict(client_enabled=True, server_enabled=servers is None,
              data_dir=data_dir, datacenter=dc, node_meta={"real": "1"},
              http_port=0, rpc_port=0, dev_mode=dev_mode)
    if servers is None:
        kw.update(use_tpu_batch_worker=True, node_name=f"server-{dc}")
    else:
        kw["client_servers"] = [tuple(servers)]
    if device is not None:
        kw["device"] = device
    agent = agent_mod.Agent(agent_mod.AgentConfig(**kw))
    node = agent.client.node
    node.name = f"real-{dc}"
    if node_id is not None:
        node.id = node_id
        agent.client.state_db.put_meta("node_id", node_id)
    if capacity is not None:
        node.resources.cpu, node.resources.memory_mb = capacity
        node_class = importlib.import_module(
            agent_mod.__name__.split(".")[0] + ".structs.node_class")
        node.computed_class = node_class.compute_node_class(node)
    if agent.server is not None:
        cluster_tune(agent.server)
        if every_solve:
            agent.server.server.scheduler_config.small_batch_threshold = 0
    agent.start()
    if agent.server is not None:
        cluster_wait(lambda: agent.server.is_leader()
                     and agent.server.server._leader,
                     "client: no established leader", 120)
    return agent


def task_verbs(driver) -> list:
    """The calls a task runner can make into a driver: the methods of
    its package's driver base class, but its fingerprint."""
    base = next(c for c in type(driver).__mro__ if c.__name__ == "Driver")
    return [v for v, f in vars(base).items()
            if callable(f) and not v.startswith("_") and v != "fingerprint"]


def stop_keeping_tasks(agent) -> None:
    """Stop a client agent and leave its tasks running
    (Client.shutdown(kill_allocs=False), the reference's agent-restart
    semantics), then the rest of the agent. One process stands for the
    agent's here: its task runners' threads end at their next call into
    a driver (SystemExit ends a thread quietly), as they would with the
    agent's process, so that none of them restarts a task the next
    incarnation has reattached."""
    client = agent.client
    client.shutdown(kill_allocs=False)

    def gone(*args, **kwargs):
        raise SystemExit

    for driver in client.drivers.values():
        for verb in task_verbs(driver):
            setattr(driver, verb, gone)
    agent.client = None
    agent.shutdown()


def restart_keeping_tasks(agent, start, what: str):
    """stop_keeping_tasks(agent), then start() it again on its data dir;
    the new agent must keep the node id. Returns the new agent."""
    node_id = agent.client.node.id
    stop_keeping_tasks(agent)
    agent = start()
    check(agent.client.node.id == node_id,
          f"{what}: the restarted client changed its node id")
    return agent


def cli_job_run(cli_main, addr: str, root: str, job_id: str, text: str,
                state, what: str, timeout_s: float) -> float:
    """`job run -detach` of `text` written as HCL under root; waits for
    its eval to complete. Returns the CLI call's seconds."""
    path = write_hcl(root, job_id, text)
    rc, out, secs = run_cli(cli_main, "-address", addr, "job", "run",
                            "-detach", path)
    check(rc == 0, f"{what}: job run {job_id} exited {rc}: {out[-300:]!r}")
    eval_id = submitted_eval(out)
    cluster_wait(lambda: state.eval_by_id(eval_id).status == "complete",
                 f"{what}: the eval of {job_id} never completed", timeout_s)
    return secs


def cli_drain(cli_main, addr: str, state, node_id: str, what: str,
              timeout_s: float) -> float:
    """`node drain -enable` of node_id; waits for the drain to end with
    no live alloc left on the node. Returns its seconds."""
    t0 = time.perf_counter()
    rc, _, _ = run_cli(cli_main, "-address", addr, "node", "drain",
                       "-enable", node_id)
    check(rc == 0, f"{what}: node drain exited {rc}")
    cluster_wait(lambda: state.node_by_id(node_id).drain_strategy is None
                 and not [a for a in state.allocs()
                          if a.node_id == node_id
                          and not a.client_terminal_status()],
                 f"{what}: the drain did not end", timeout_s)
    return time.perf_counter() - t0


def cli_stop_jobs(cli_main, addr: str, srv, job_ids, what: str,
                  timeout_s: float) -> None:
    """`job stop` of each job; waits for every alloc to end on its
    client and the cluster to settle."""
    for job_id in job_ids:
        rc, _, _ = run_cli(cli_main, "-address", addr, "job", "stop",
                           job_id)
        check(rc == 0, f"{what}: job stop {job_id} exited {rc}")
    cluster_wait(lambda: all(a.client_terminal_status()
                             for a in srv.state.allocs()),
                 f"{what}: the stopped allocs did not end", timeout_s)
    wait_client_settled(srv, f"{what} stop", timeout_s)


def node_ready(state, node_id: str) -> bool:
    n = state.node_by_id(node_id)
    return n is not None and n.status == "ready"


def task_handles(client, alloc_ids) -> dict:
    """{(alloc id, task): the driver handle's state} a client persisted:
    a raw_exec task's pid, an exec task's executor pid and socket."""
    out = {}
    for aid in alloc_ids:
        for task in ("dev", "box", "raw"):
            h = client.state_db.get_task_handle(aid, task)
            if h:
                out[(aid, task)] = dict(h.get("state", {}))
    return out


def pid_alive(pid) -> bool:
    """A process exists and is not a zombie."""
    try:
        with open(f"/proc/{int(pid)}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, ValueError, IndexError):
        return False


def handle_pids(state: dict) -> list:
    return [state[k] for k in ("pid", "daemon_pid") if state.get(k)]


def settled(srv) -> bool:
    """No eval pending or in flight, nothing queued to plan, no alloc
    waiting for its client: every live alloc pending on nothing."""
    st = srv.state
    return (srv.eval_broker.inflight_count() == 0
            and srv.plan_queue.depth() == 0
            and all(e.status != "pending" for e in st.evals())
            and all(a.client_status != "pending" for a in st.allocs()
                    if a.desired_status == "run"))


def wait_client_settled(srv, what: str, timeout_s: float,
                        quiet_s: float = 1.0):
    """settled(srv) held through quiet_s with the store's index still."""
    t0 = time.perf_counter()
    mark = None
    while True:
        check(time.perf_counter() - t0 < timeout_s,
              f"client: {what} did not settle in {timeout_s} s")
        if settled(srv):
            idx = srv.state.latest_index()
            if mark is None or mark[0] != idx:
                mark = (idx, time.perf_counter())
            elif time.perf_counter() - mark[1] >= quiet_s:
                return time.perf_counter() - t0
        else:
            mark = None
        time.sleep(0.05)


def deployment_status(state, job_id: str):
    deps = [d for d in state.deployments() if d.job_id == job_id]
    if not deps:
        return None
    return max(deps, key=lambda d: d.create_index).status


def run_cli_bytes(cli_main, *argv) -> tuple:
    """A CLI command in this process whose output may be bytes (alloc
    logs, alloc fs): (exit code, its standard output, seconds)."""
    import contextlib
    import io

    raw = io.BytesIO()
    text = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = cli_main(list(argv))
    text.flush()
    return rc, raw.getvalue().decode(errors="replace"), \
        time.perf_counter() - t0


def cli_exec(pkg: str, addr: str, alloc_id: str, *cmd) -> tuple:
    """`alloc exec` through the CLI in a process of its own, no input:
    (exit code, standard output)."""
    import os

    proc = subprocess.run(
        [sys.executable, "-m", f"{pkg}.cli", "-address", addr, "alloc",
         "exec", alloc_id, *cmd],
        stdin=subprocess.DEVNULL, capture_output=True, text=True,
        timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc.returncode, proc.stdout


class StreamPaths:
    """Counts the cluster's client streams (alloc logs, fs, exec) by the
    path they took: the forward dial to the client's advertised address
    (ConnPool.stream) or a reverse session the client parked."""

    def __init__(self, cluster) -> None:
        self.cluster = cluster
        self.counts = {"forward": 0, "reverse": 0}
        self._stream = cluster.pool.stream
        self._take = cluster.take_reverse_session
        cluster.pool.stream = self.stream
        cluster.take_reverse_session = self.take

    def stream(self, *args, **kw):
        s = self._stream(*args, **kw)
        self.counts["forward"] += 1
        return s

    def take(self, *args, **kw):
        s = self._take(*args, **kw)
        if s is not None:
            self.counts["reverse"] += 1
        return s

    def restore(self) -> None:
        del self.cluster.pool.stream
        del self.cluster.take_reverse_session


class UpdateLog:
    """Counts the server's client alloc updates (Node.update_allocs, the
    reference's Node.UpdateAlloc) and the allocs each carried."""

    def __init__(self, srv) -> None:
        self.srv = srv
        self.sizes = []
        self._real = srv.update_allocs_from_client
        srv.update_allocs_from_client = self

    def __call__(self, allocs):
        self.sizes.append(len(allocs))
        return self._real(allocs)

    def restore(self) -> None:
        del self.srv.update_allocs_from_client


class PeakSampler:
    """The process's live threads, sampled every 0.2 s on a thread of
    its own, and its resident memory: their peaks (the memory's over
    the whole process so far)."""

    def __init__(self) -> None:
        self.threads = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="peak-sampler")

    def _run(self) -> None:
        while not self._stop.is_set():
            self.threads = max(self.threads, threading.active_count())
            self._stop.wait(0.2)

    def start(self) -> None:
        self._t.start()

    def stop(self) -> dict:
        import resource

        self._stop.set()
        self._t.join()
        # ru_maxrss is in KiB on Linux: the process's peak so far
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        return {"peak_threads": self.threads, "peak_rss_mb": rss}


def client_names(state) -> dict:
    """agent_names with each eval named by its job and trigger alone
    (which of a drain's evals places a replacement depends on when the
    client reports the migrating alloc), and each node id by its node's
    name."""
    names = agent_names(state)
    for e in state.evals():
        names[e.id] = f"eval:{e.job_id}/{e.triggered_by}"
    for n in state.nodes():
        names[n.id] = f"node:{n.name}"
    return names


def alloc_view(state, names: dict) -> list:
    """Every alloc by (job, alloc name, node name) with its desired and
    client status."""
    return sorted((a.job_id, a.name, names.get(a.node_id, a.node_id),
                   a.desired_status, a.client_status)
                  for a in state.allocs())


def task_event_view(state, names: dict) -> list:
    """Each alloc's task states by their event types."""
    return sorted(
        (a.job_id, a.name, names.get(a.node_id, a.node_id), t,
         tuple(e["type"] for e in ts.events))
        for a in state.allocs() for t, ts in sorted(a.task_states.items()))


# what differs between two runs of the same operations on a client: the
# agent_lockstep's volatile fields, and the pids, sockets and paths of
# the tasks the client ran
_CLIENT_VOLATILE = re.compile(
    r"(^|_)(index|time|at|ttl|ns|pid|timestamp)$|^wait_until$"
    r"|^socket_path$|_dir$|_path$")


def client_http_view(body, names: dict):
    """http_view with the client's volatile fields dropped too."""
    if isinstance(body, dict):
        return {k: client_http_view(v, names) for k, v in body.items()
                if not _CLIENT_VOLATILE.search(k)}
    if isinstance(body, list):
        items = [client_http_view(v, names) for v in body]
        if items and all(isinstance(v, dict) for v in items):
            items.sort(key=lambda v: json.dumps(v, sort_keys=True))
        return items
    if isinstance(body, str):
        return names.get(body, body)
    return body


def restart_outcome(state, node_id: str, job_ids, names: dict) -> list:
    """The mock allocs of job_ids that were on a node when its client
    agent restarted: each one's desired and client status and its task's
    event types (the same for every such alloc, as a set)."""
    return sorted({(a.desired_status, a.client_status,
                    tuple(e["type"] for ts in a.task_states.values()
                          for e in ts.events))
                   for a in state.allocs()
                   if a.node_id == node_id and a.job_id in job_ids})


def client_lockstep(agent_mod, cli_main, nodes: list, device=None,
                    cfg=CLIENT_SMALL) -> dict:
    """CLIENT_SMALL through a dev agent and one client agent of one
    package (agent_mod, cli_main: its agent module and CLI; device: the
    port's, None for nomad_tpu), one step at a time, each settled before
    the next: the two real nodes (dc1 the dev agent's, dc2 the client
    agent's; ids and capacity pinned) ready, then `nodes` registered
    over the fabric; two mock-driver jobs of cfg["count"] as HCL through
    `job run` (every alloc running, the deployment successful), one
    raw_exec task; dc1's node drained through `node drain` (its allocs
    migrate to dc2, waiting on their previous allocs); the client agent
    stopped with its tasks left running and started again on its data
    dir; every job stopped through `job stop`. Returns the allocs
    (alloc_view) after each step, the task states' event types, the
    deployments' statuses, the raw_exec task's handle kept across the
    restart, the mock allocs' restart outcome and the bodies of
    /v1/job/<id>/allocations and /v1/node/<id>/allocations
    (client_http_view)."""
    import importlib
    import shutil
    import tempfile
    import urllib.request

    pkg = agent_mod.__name__.split(".")[0]
    rpc = importlib.import_module(pkg + ".rpc")
    cap = (cfg["cpu"], cfg["memory"])
    root = tempfile.mkdtemp(prefix="client-lockstep-")
    pool = rpc.ConnPool()
    dev = cl = None
    out: dict = {"steps": {}}
    try:
        dev = start_real_agent(agent_mod, root + "/dc1", "dc1",
                               device=device, dev_mode=True,
                               every_solve=True,
                               node_id=LOCK_NODE_IDS[0], capacity=cap)
        srv = dev.server.server
        state = srv.state
        cluster_wait(lambda: node_ready(state, LOCK_NODE_IDS[0]),
                     "lockstep: dc1's node not ready", 60)

        def client_agent():
            return start_real_agent(agent_mod, root + "/dc2", "dc2",
                                    servers=dev.server.addr,
                                    node_id=LOCK_NODE_IDS[1], capacity=cap)

        cl = client_agent()
        cluster_wait(lambda: node_ready(state, LOCK_NODE_IDS[1]),
                     "lockstep: dc2's node not ready", 60)
        for n in nodes:
            pool.call(dev.server.addr, "Node.register", {"node": n},
                      timeout_s=60.0)
        cluster_wait(lambda: len(state.nodes()) == len(nodes) + 2,
                     "lockstep: the fleet did not register", 60)
        addr = "http://{}:{}".format(*dev.http_addr)
        dcs = hcl_dcs(("dc1", "dc2"))

        def run(job_id, text):
            cli_job_run(cli_main, addr, root, job_id, text, state,
                        "lockstep", 120)

        mock_jobs = [f"mock-{j}" for j in range(cfg["jobs"])]
        for job_id in mock_jobs:
            run(job_id, CLIENT_HCL.format(id=job_id, dcs=dcs,
                                          count=cfg["count"],
                                          migrate=cfg["count"]))
            cluster_wait(lambda: deployment_status(state, job_id)
                         == "successful",
                         f"lockstep: {job_id}'s deployment", 120)
        run("raw", RAW_HCL.format(id="raw", dcs=dcs))
        wait_client_settled(srv, "lockstep run", 120)
        names = client_names(state)
        out["steps"]["run"] = alloc_view(state, names)

        cli_drain(cli_main, addr, state, LOCK_NODE_IDS[0], "lockstep", 120)
        wait_client_settled(srv, "lockstep drain", 120)
        names = client_names(state)
        out["steps"]["drain"] = alloc_view(state, names)

        raw = [a.id for a in state.allocs_by_job("default", "raw")
               if a.node_id == LOCK_NODE_IDS[1]
               and a.client_status == "running"]
        before = task_handles(cl.client, raw)
        check(before and all(pid_alive(p) for h in before.values()
                             for p in handle_pids(h)),
              "lockstep: the raw_exec task is not running on dc2")
        cl = restart_keeping_tasks(cl, client_agent, "lockstep")
        wait_client_settled(srv, "lockstep restart", 120, quiet_s=2.0)
        after = task_handles(cl.client, raw)
        out["raw_kept"] = (after == before and all(
            pid_alive(p) for h in after.values() for p in handle_pids(h)))
        names = client_names(state)
        out["steps"]["restart"] = alloc_view(state, names)
        out["restart_outcome"] = restart_outcome(
            state, LOCK_NODE_IDS[1], set(mock_jobs), names)

        cli_stop_jobs(cli_main, addr, srv, mock_jobs + ["raw"], "lockstep",
                      120)
        gone = all(not pid_alive(p) for h in before.values()
                   for p in handle_pids(h))
        check(gone, "lockstep: the raw_exec task outlived its job")
        names = client_names(state)
        out["steps"]["stop"] = alloc_view(state, names)
        out["events"] = task_event_view(state, names)
        out["deployments"] = sorted((d.job_id, d.job_version, d.status)
                                    for d in state.deployments())
        paths = {f"/v1/job/{j}/allocations": j for j in mock_jobs + ["raw"]}
        paths.update({f"/v1/node/{nid}/allocations": names[nid]
                      for nid in LOCK_NODE_IDS})
        out["reads"] = {}
        for path, what in paths.items():
            with urllib.request.urlopen(addr + path, timeout=60) as resp:
                out["reads"][what] = client_http_view(
                    json.loads(resp.read()), names)
        return out
    finally:
        for a in (cl, dev):
            if a is not None:
                a.shutdown()
        pool.shutdown()
        shutil.rmtree(root, ignore_errors=True)


def card_uuids() -> list:
    """The card's UUIDs as nvidia-smi lists them (the ids a client's
    NvidiaDevicePlugin fingerprints)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def real_per_node(nodes, want: int) -> tuple:
    """Allocs of CLIENT_ASK a real node takes: `want`, or fewer where the
    node's (pinned) capacity, less the exec job's two tasks, could not
    also take a quarter more (the drained node's share, spread over the
    other three). Returns (per node, the capacity it was cut by or
    None)."""
    fits = min(min((n.resources.cpu - n.reserved.cpu
                    - 2 * EXEC_ASK["cpu"]) // CLIENT_ASK["cpu"],
                   (n.resources.memory_mb - n.reserved.memory_mb
                    - 2 * EXEC_ASK["memory"]) // CLIENT_ASK["memory"])
               for n in nodes)
    room = fits * 3 // 4
    if room >= want:
        return want, None
    cap = min(((n.resources.cpu, n.resources.memory_mb) for n in nodes))
    return room, {"cpu_mhz": cap[0], "memory_mb": cap[1],
                  "fits": fits}


def client_scenario(device: str, cfg: dict, on_step) -> dict:
    """The client phase (CLIENT) on a server agent with a co-located
    client (dc1, the GPU batch worker on `device`, a durable raft log)
    and three client agents (dc2-dc4) joined over the fabric:
    client.setup, client.run, client.exec, client.drain, client.restart,
    client.stop (module docstring, phase 12). Launch counters zeroed
    just before the first `job run` and read after the last `job stop`
    settles."""
    import os
    import shutil
    import tempfile

    from nomad_tpu_torch import agent as agent_mod
    from nomad_tpu_torch import metrics
    from nomad_tpu_torch.cli.main import main as cli_main
    from nomad_tpu_torch.metrics import Registry
    from nomad_tpu_torch.rpc import ConnPool

    metrics._install_registry(Registry())
    trace.clear_finished()
    cores = os.cpu_count() or 1
    cap = (cores * cfg["core_mhz"], cores * cfg["core_mb"])
    root = tempfile.mkdtemp(prefix="client-")
    out: dict = {"steps": {}}
    steps = out["steps"]
    pool = ConnPool()
    agents: dict = {}
    hooks = []
    sampler = PeakSampler()
    sampler.start()
    syncs = SyncLog()
    hooks.append(syncs)
    try:
        # client.setup
        t0 = time.perf_counter()
        server = start_real_agent(agent_mod, root + "/dc1", "dc1",
                                  device=device, capacity=cap)
        agents["dc1"] = server
        srv = server.server.server
        state = srv.state
        lead_s = time.perf_counter() - t0

        def client_agent(dc):
            return start_real_agent(agent_mod, f"{root}/{dc}", dc,
                                    servers=server.server.addr,
                                    capacity=cap)

        for dc in CLIENT_DCS[1:]:
            agents[dc] = client_agent(dc)
        real_ids = {dc: a.client.node.id for dc, a in agents.items()}
        t_reg = time.perf_counter()
        register_fleet(pool, server.server.addr, c2m_nodes(cfg["nodes"]),
                       cfg["threads"], "client")
        want_nodes = cfg["nodes"] + len(CLIENT_DCS)
        cluster_wait(lambda: sum(1 for n in state.nodes()
                                 if n.status == "ready") == want_nodes,
                     f"client: {want_nodes} nodes not ready", 300)
        reg_s = time.perf_counter() - t_reg
        uuids = card_uuids() if cfg["gpu"] else []
        real = {dc: state.node_by_id(nid) for dc, nid in real_ids.items()}
        for dc, n in real.items():
            for drv in ("mock", "rawexec", "exec"):
                info = n.drivers.get(drv)
                check(info is not None and info.detected and info.healthy
                      and n.attributes.get(f"driver.{drv}") == "1",
                      f"client: driver.{drv} not detected on {dc}: "
                      f"{info and info.health_description!r}")
            if cfg["gpu"]:
                gpus = [d for d in (n.resources.devices or [])
                        if d.vendor == "nvidia" and d.type == "gpu"]
                check(gpus and sorted(i.id for d in gpus
                                      for i in d.instances) == uuids,
                      f"client: {dc}'s nvidia/gpu device does not carry "
                      f"the card's UUID {uuids}")
        steps["setup"] = {
            "wall_s": time.perf_counter() - t0, "leader_s": lead_s,
            "register_s": reg_s, "nodes_ready": want_nodes,
            "real_nodes": {dc: {"cpu_mhz": n.resources.cpu,
                                "memory_mb": n.resources.memory_mb,
                                "drivers": sorted(
                                    d for d, i in n.drivers.items()
                                    if i.detected),
                                "devices": [f"{d.vendor}/{d.type}/{d.name}"
                                            for d in (n.resources.devices
                                                      or [])]}
                           for dc, n in real.items()},
            "card_uuids": uuids}
        on_step("client.setup", steps["setup"]["wall_s"],
                **{k: v for k, v in steps["setup"].items()
                   if k != "wall_s"})

        # client.run: one service job of 4 x per_node mock allocs
        addr = "http://{}:{}".format(*server.http_addr)
        per, cut = real_per_node(real.values(), cfg["per_node"])
        check(per > 0, "client: a real node fits no c2m alloc")
        count = per * len(CLIENT_DCS)
        dcs = hcl_dcs(CLIENT_DCS)
        updates = UpdateLog(srv)
        hooks.append(updates)
        paths = StreamPaths(server.server)
        hooks.append(paths)
        tk.reset_launch_counts()
        m0 = metrics.snapshot()
        t_run = time.perf_counter()
        job_run_s = cli_job_run(cli_main, addr, root, "c2m-real",
                                CLIENT_HCL.format(id="c2m-real", dcs=dcs,
                                                  count=count, migrate=per),
                                state, "client", 300)
        placed_s = time.perf_counter() - t_run

        def running(job_id):
            return [a for a in state.allocs_by_job("default", job_id)
                    if a.client_status == "running"
                    and a.desired_status == "run"]

        cluster_wait(lambda: len(running("c2m-real")) == count,
                     f"client: {count} allocs not running", 600)
        running_s = time.perf_counter() - t_run
        cluster_wait(lambda: deployment_status(state, "c2m-real")
                     == "successful",
                     "client: the deployment did not succeed", 600)
        success_s = time.perf_counter() - t_run
        m1 = metrics.snapshot()
        traces = batch_traces()
        trace.clear_finished()
        per_node = {dc: sum(1 for a in running("c2m-real")
                            if a.node_id == nid)
                    for dc, nid in real_ids.items()}
        check(all(v == per for v in per_node.values()),
              f"client: allocs a real node {per_node}, want {per} each")
        run = wave_numbers(m0, m1, traces, running_s, 1, count)
        run.update(
            allocs=count, per_node=per, cut=cut,
            job_run_ms=1e3 * job_run_s, placed_s=placed_s,
            all_running_s=running_s, deployment_successful_s=success_s,
            update_allocs_calls=len(updates.sizes),
            update_allocs_allocs=sum(updates.sizes),
            update_allocs_max=max(updates.sizes, default=0),
            launches=launch_counts(), threads=threading.active_count())
        steps["run"] = run
        on_step("client.run", running_s,
                **{k: v for k, v in run.items() if k != "wall_s"})

        # client.exec: a raw_exec task (given the card) and an exec task
        # on every real node; logs, exec and fs through the CLI
        t_exec = time.perf_counter()
        n_exec = cfg["exec_count"]
        cli_job_run(cli_main, addr, root, "procs", EXEC_HCL.format(
            id="procs", dcs=dcs, count=n_exec,
            device=EXEC_DEVICE if cfg["gpu"] else ""), state, "client", 300)
        cluster_wait(lambda: len(running("procs")) == 2 * n_exec,
                     "client: the process tasks are not running", 300)
        node_dc = {nid: dc for dc, nid in real_ids.items()}
        calls = {}
        for a in sorted(running("procs"), key=lambda a: a.name):
            dc = node_dc[a.node_id]
            f0 = dict(paths.counts)
            if a.task_group == "dev":
                want = "dev=" + ",".join(uuids)
                got = ""
                for _ in range(100):
                    rc, got, _ = run_cli_bytes(cli_main, "-address", addr,
                                               "alloc", "logs", a.id, )
                    if want in got:
                        break
                    time.sleep(0.1)
                check(rc == 0 and f"{want}\n" in got,
                      f"client: alloc logs of {a.name} on {dc} show "
                      f"{got!r}, want {want!r}")
            rc, got = cli_exec("nomad_tpu_torch", addr, a.id, "echo", "hi")
            check(rc == 0 and got.strip() == "hi",
                  f"client: alloc exec on {dc}'s {a.name} gave {rc} "
                  f"{got!r}")
            rc, listing, _ = run_cli_bytes(cli_main, "-address", addr,
                                           "alloc", "fs", a.id)
            check(rc == 0 and a.task_group in listing,
                  f"client: alloc fs of {a.name} on {dc} lists "
                  f"{listing!r}")
            calls[f"{dc}/{a.task_group}"] = {
                k: paths.counts[k] - f0[k] for k in f0}
        steps["exec"] = {"wall_s": time.perf_counter() - t_exec,
                         "paths": calls, "streams": dict(paths.counts)}
        on_step("client.exec", steps["exec"]["wall_s"],
                **{k: v for k, v in steps["exec"].items() if k != "wall_s"})

        # client.drain: dc4's node through `node drain`
        t_drain = time.perf_counter()
        drain_s = cli_drain(cli_main, addr, state, real_ids["dc4"],
                            "client", 600)
        cluster_wait(lambda: len(running("c2m-real")) == count,
                     "client: the drained allocs are not running again",
                     600)
        wait_client_settled(srv, "client drain", 600)
        on_three = {dc: sum(1 for a in running("c2m-real")
                            if a.node_id == nid)
                    for dc, nid in real_ids.items()}
        check(on_three["dc4"] == 0 and sum(on_three.values()) == count,
              f"client: after the drain {on_three}, want {count} on "
              "dc1-dc3")
        procs_left = sorted(a.name for a in running("procs"))
        steps["drain"] = {"wall_s": time.perf_counter() - t_drain,
                          "drain_s": drain_s, "per_node": on_three,
                          "procs_running": procs_left,
                          "update_allocs_calls": len(updates.sizes)}
        on_step("client.drain", steps["drain"]["wall_s"],
                **{k: v for k, v in steps["drain"].items()
                   if k != "wall_s"})

        # client.restart: dc3's client agent stopped with its tasks
        # running, started again on its data dir
        t_rs = time.perf_counter()
        nid = real_ids["dc3"]
        procs = [a.id for a in running("procs") if a.node_id == nid]
        before = task_handles(agents["dc3"].client, procs)
        check(len(before) == 2 and all(
            pid_alive(p) for h in before.values() for p in handle_pids(h)),
              f"client: dc3's process tasks are not running: {before}")
        restarts0 = {a.id: {t: ts.restarts for t, ts in
                            a.task_states.items()}
                     for a in state.allocs() if a.id in procs}
        mock_ids = {a.id for a in running("c2m-real") if a.node_id == nid}
        agents["dc3"] = restart_keeping_tasks(
            agents.pop("dc3"), lambda: client_agent("dc3"), "client")
        wait_client_settled(srv, "client restart", 600, quiet_s=2.0)
        after = task_handles(agents["dc3"].client, procs)
        check(after == before and all(
            pid_alive(p) for h in after.values() for p in handle_pids(h)),
              f"client: dc3's process tasks were not reattached: {before} "
              f"-> {after}")
        restarts1 = {a.id: {t: ts.restarts for t, ts in
                            a.task_states.items()}
                     for a in state.allocs() if a.id in procs}
        check(restarts1 == restarts0 and all(
            a.client_status == "running" for a in state.allocs()
            if a.id in procs),
              f"client: a process task restarted: {restarts0} -> "
              f"{restarts1}")
        names = client_names(state)
        outcome = sorted({(a.desired_status, a.client_status,
                           tuple(e["type"] for ts in a.task_states.values()
                                 for e in ts.events))
                          for a in state.allocs() if a.id in mock_ids})
        steps["restart"] = {"wall_s": time.perf_counter() - t_rs,
                            "node_id_kept": True, "pids": {
                                names[aid] + "/" + task: handle_pids(h)
                                for (aid, task), h in before.items()},
                            "mock_allocs": len(mock_ids)}
        out["restart_outcome"] = outcome
        on_step("client.restart", steps["restart"]["wall_s"],
                **{k: v for k, v in steps["restart"].items()
                   if k != "wall_s"}, mock_outcome=outcome)

        # client.stop: both jobs through `job stop`
        t_stop = time.perf_counter()
        proc_ids = [a.id for a in state.allocs_by_job("default", "procs")]
        all_procs = {}
        for a in agents.values():
            all_procs.update(task_handles(a.client, proc_ids))
        cli_stop_jobs(cli_main, addr, srv, ("c2m-real", "procs"), "client",
                      600)
        stop_s = time.perf_counter() - t_stop
        left = [p for h in all_procs.values() for p in handle_pids(h)
                if pid_alive(p)]
        check(not left, f"client: task processes left after job stop: "
              f"{left}")
        statuses = {}
        for a in state.allocs():
            statuses[a.client_status] = statuses.get(a.client_status, 0) + 1
        check(set(statuses) == {"complete"},
              f"client: allocs after the stop: {statuses}")
        out["launches"] = launch_counts()
        steps["stop"] = {"wall_s": stop_s, "allocs": statuses,
                         "processes_checked": sum(
                             len(handle_pids(h))
                             for h in all_procs.values()),
                         "update_allocs_calls": len(updates.sizes),
                         "update_allocs_allocs": sum(updates.sizes)}
        on_step("client.stop", stop_s,
                **{k: v for k, v in steps["stop"].items() if k != "wall_s"})
        out["counters"] = metrics.snapshot()["counters"]
        out["resident"] = srv.tpu_worker._resident
        # each compact solve's sync of the worker's resident tensors: a
        # delta runs K2
        out["syncs"] = syncs.of(out["resident"])
    finally:
        for h in reversed(hooks):
            h.restore()
        t0 = time.perf_counter()
        for a in reversed(list(agents.values())):
            a.shutdown()
        pool.shutdown()
        out["shutdown_s"] = time.perf_counter() - t0
        out.update(sampler.stop())
        shutil.rmtree(root, ignore_errors=True)
    return out


def check_client_run(res) -> None:
    """No device failover or failed batch, K1 on the path, its resident
    tensors on cuda:0."""
    c = res["counters"]
    check(c.get("nomad.worker.device_failover", 0) == 0,
          "client: a device failover")
    check(c.get("nomad.worker.invoke.failed", 0) == 0,
          "client: a batch failed to solve or commit")
    check(res["launches"]["solve_placement_compact"] > 0,
          "client: K1 was not launched on the client path")
    cuda0 = torch.device("cuda", 0)
    r = res["resident"]
    check(r is not None and r._cap_dev.device == cuda0
          and r._used_dev.device == cuda0,
          "client: the worker's resident tensors are not on cuda:0")


def client_small(device: str, nodes: list) -> dict:
    """client_lockstep on the port's agents, the batch worker on
    `device` with every solve on it (small_batch_threshold 0)."""
    from nomad_tpu_torch import agent as agent_mod
    from nomad_tpu_torch.cli.main import main as cli_main

    return client_lockstep(agent_mod, cli_main, [n.copy() for n in nodes],
                           device=device)


# ---------------------------------------------------------------------------
# the mesh route: c2m_sharded at full width, the preempt wave on 8 shards
# ---------------------------------------------------------------------------

# The drain phase: bench.py run_drain_config's 20 service jobs and 10%
# drain ratio at c2m's width, 1,000 allocs a job, with a sysbatch job and
# a rollout that overlaps the drain added (drain_scenario)
DRAIN_SVC_JOBS, DRAIN_SVC_COUNT, DRAIN_NODES = 20, 1000, 1000
DRAIN_WORKLOAD = "BASELINE config 5 with an overlapping rollout"

# bench.py run_c2m_sharded_config's defaults (BENCH_SHARDED_NODES / JOBS /
# COUNT); its device phase was an injected sleep, so only its shapes are
# taken
SHARDED_NODES, SHARDED_JOBS, SHARDED_COUNT = 100_000, 16, 500
SHARDED_ROUNDS = 5


def c2m_sharded(on_phase) -> dict:
    """100,000 nodes at 4000 MHz / 8192 MB and rounds of 16 jobs x 500
    allocs of 250 MHz / 128 MB with no constraint or spread. Round 1 is
    solved on one snapshot three ways, uncommitted: the single-card
    route (K1), a 1-shard and an 8-shard mesh (K6); the plans must be
    identical. Then bench.py's pipelined sequence on the 8-shard mesh,
    with the launch counters zeroed: begin(N+1) chains on batch N's
    in-flight used' before finish(N) and its commit; the resident shards
    take a full upload, then delta syncs."""
    t0 = time.perf_counter()
    h = build_c2m(SHARDED_NODES)
    rounds = [add_jobs(h, f"s{r}", SHARDED_JOBS, SHARDED_COUNT,
                       constrained=False) for r in range(SHARDED_ROUNDS)]
    on_phase("mesh.build", t0, nodes=SHARDED_NODES)

    t0 = time.perf_counter()
    snap = h.snapshot()
    placed, solve_s = {}, {}
    for label, shards in (("single_card", 0), ("d1", 1), ("d8", 8)):
        cfg = SchedulerConfig(small_batch_threshold=0, device="cuda",
                              mesh_devices=shards)
        evs = [mock.eval_for_job(j) for j in rounds[0]]
        t = time.perf_counter()
        plans = gpu.solve_eval_batch(snap, h, evs, cfg)
        solve_s[label] = time.perf_counter() - t
        check(not any(ev.failed_tg_allocs for ev in evs),
              f"round 1 ({label}) failed to place")
        placed[label] = placements(plans, evs)
    check(len(placed["single_card"]) == SHARDED_JOBS * SHARDED_COUNT,
          "round 1 placed too few allocs")
    for label in ("d1", "d8"):
        check(placed[label] == placed["single_card"],
              f"round 1 on the {label} mesh differs from the single card")
    on_phase("mesh.round1_three_ways", t0, solve_s=solve_s,
             allocs_compared=len(placed["single_card"]))

    mesh = gpu.solver_mesh(8, "cuda")
    resident = gpu.ResidentClusterState(mesh=mesh)
    cfg = SchedulerConfig(small_batch_threshold=0, device="cuda",
                          mesh_devices=8)
    rec = Recorder(gpu.sharding, "sharded_solver")
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    syncs, walls, stages, prev = [], [], [], None
    t_last = t0
    for i, jobs in enumerate(rounds + [None]):
        # one trace per step: begin(N+1), then finish(N) and its commit
        ctx = trace.TraceContext(f"step{i}")
        trace_cm = trace.use(ctx)
        trace_cm.__enter__()
        pend = None
        if jobs is not None:
            evs = [mock.eval_for_job(j) for j in jobs]
            pend = gpu.solve_eval_batch_begin(
                h.snapshot(), h, evs, cfg, resident=resident,
                used_chain=prev[0].chain if prev else None,
            )
            syncs.append(resident.last_sync
                         + ("+chain" if pend.chain_accepted else ""))
        if prev is not None:
            p_pend, p_evs = prev
            plans = p_pend.finish()
            commit(h, plans, p_evs)
            for ev in p_evs:
                check(not ev.failed_tg_allocs,
                      f"eval {ev.job_id} failed: {ev.failed_tg_allocs}")
            now = time.perf_counter()
            walls.append(now - t_last)
            t_last = now
        trace_cm.__exit__(None, None, None)
        stages.append(stage_ms(ctx))
        prev = (pend, evs) if pend is not None else None
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in tk.KERNELS}
    rec.restore()
    on_phase("mesh.pipelined", t0, round_walls_s=walls, syncs=syncs,
             shard_map=mesh.shard_map(), launches=launches,
             step_stages_ms=stages)
    check(launches["sharded_solver"] > 0, "K6 did not launch on the mesh")
    check(launches["solve_placement_compact"] == 0,
          "K1 launched on the mesh path")
    check(syncs[0] == "full" and all("+chain" in x for x in syncs[1:])
          and any(x.startswith("delta:") for x in syncs),
          f"sync sequence {syncs}")
    on_card = [resident._cap_dev, resident._used_dev] + rec.tensors
    check(all(t.is_cuda for t in on_card),
          "a resident shard or a K6 operand is on the host")
    live = sum(1 for a in h.state.allocs() if not a.terminal_status())
    want = SHARDED_ROUNDS * SHARDED_JOBS * SHARDED_COUNT
    check(live == want, f"{live} live allocs, want {want}")
    for node in h.state.nodes():
        u = h.state.node_usage(node.id)
        cap = node.available_resources()
        check(u[0] <= cap.cpu and u[1] <= cap.memory_mb,
              f"node {node.id} over capacity: {u} > {cap}")
    return {"launches": launches["sharded_solver"], "rec": rec,
            "solves": SHARDED_ROUNDS}


def preempt_on_mesh(on_phase) -> dict:
    """The preempt phase's fleet and wave (10,000 nodes 90% full, 20 x
    1,000 at priority 70), solved on one snapshot through the single-card
    route and on an 8-shard mesh, with the launch counters zeroed around
    the mesh solve: placements, victims and preempted allocations must
    be identical. The mesh's plans are committed."""
    t0 = time.perf_counter()
    h, jobs = preempt_fleet("cuda", 10000, C2M_FILLS, (20, 1000, True))
    on_phase("mesh.preempt_fleet", t0)
    snap = h.snapshot()
    out, solve_s = {}, {}
    rec = None
    for label, shards in (("single_card", 0), ("d8", 8)):
        cfg = SchedulerConfig(preemption_service=True,
                              small_batch_threshold=0, device="cuda",
                              mesh_devices=shards)
        evs = [mock.eval_for_job(j) for j in jobs]
        if shards:
            rec = Recorder(gpu.sharding, "sharded_solver_preempt")
            tk.reset_launch_counts()
        t = time.perf_counter()
        plans = gpu.solve_eval_batch(snap, h, evs, cfg)
        torch.cuda.synchronize()
        solve_s[label] = time.perf_counter() - t
        out[label] = (plans, evs, preempt_outcome(h, plans, evs))
    launches = {fn.__name__: fn.launches for fn in tk.KERNELS}
    route = tk.sharded_solver_preempt.last_route
    replays = tk.sharded_solver_preempt.graph_replays
    rec.restore()
    check(route in ("graph_capture", "graph_replay") and replays == 1,
          f"K7 on one card took the {route} route ({replays} replays)")
    ref, got = out["single_card"][2], out["d8"][2]
    for k in ("placed", "preempted_by", "victims", "unplaced"):
        check(got[k] == ref[k], f"preempt wave on the mesh differs in {k}")
    check(launches["sharded_solver_preempt"] > 0,
          "K7 did not launch on the mesh's preempt wave")
    check(all(t.is_cuda for t in rec.tensors), "a K7 operand is on the host")
    plans, evs, res = out["d8"]
    commit(h, plans, evs)
    res["h"] = h
    check_preempt(res, 20 * 1000, {65: 25 * 900})
    # the wave's graph, captured by its first solve of this shape
    a = rec.first[0]
    capture_s = tk.sharded_solver_preempt.graphs[
        (a[0].shape[0], a[3].shape[0], a[2].shape[0], 8,
         a[0].device.index)]["capture_s"]
    on_phase("mesh.preempt_wave", t0, solve_s=solve_s, launches=launches,
             placed=len(got["placed"]), evicted=len(got["victims"]),
             route=route, capture_s=capture_s)
    return {"launches": launches["sharded_solver_preempt"], "rec": rec,
            "solves": 1, "graph_replays": replays, "capture_s": capture_s}


class Recorder:
    """Wraps a kernel wrapper where the solver calls it, keeping a copy
    of the first call's inputs (before a donated call writes them); with
    `keep`, of the first call whose arguments it accepts."""

    def __init__(self, mod, name: str, keep=None) -> None:
        self.mod, self.name = mod, name
        self.real = getattr(mod, name)
        self.keep = keep
        self.first = None
        self.tensors = []
        setattr(mod, name, self)

    def __call__(self, *args, **kwargs):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if self.first is None and (self.keep is None or self.keep(args)):
            self.first = ([a.clone() if isinstance(a, torch.Tensor)
                           else a for a in args], dict(kwargs))
        out = self.real(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        self.tensors.extend(tensors + list(outs))
        return out

    def __getattr__(self, attr):
        # the wrapper's own state (launch counts, route), read through
        if attr == "real":
            raise AttributeError(attr)
        return getattr(self.real, attr)

    def restore(self) -> None:
        setattr(self.mod, self.name, self.real)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs_err(got, want) -> float:
    """Largest elementwise |kernel - twin| over all outputs (the
    tolerance is exact: every output is integer or boolean)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(
        float((g.long() - w.long()).abs().max()) for g, w in zip(got, want)
    )


def hold_k1(args, kw) -> dict:
    """One K1 call against its twin (exact), then timed: its error,
    device, enqueue and twin times, the bytes and operations its
    function needs, its launch info and shape."""
    got = tk.solve_placement_compact(*args, **kw)
    want = tk.solve_placement_compact_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    cap, used, asks, counts, fp, fi, br, bi, ur, ui = args
    inst, over, used_out = got
    live_groups = int((counts > 0).sum())
    ms, enq = device_ms(lambda: tk.solve_placement_compact(*args, **kw), 10)
    plain_ms = time_ms(
        lambda: tk.solve_placement_compact_plain(*args, **kw), 3
    )
    return {
        "max_abs_err": err, "ms": ms, "enqueue_ms": enq,
        "plain_ms": plain_ms,
        "nbytes": nbytes(cap, used, asks, counts, fp, fi, br, bi, ur, ui,
                         inst, over, used_out),
        "ops": live_groups * cap.shape[0] * SCORE_FLOPS,
        "launch": tk.solve_placement_compact.last_launch,
        "shape": {"np": cap.shape[0], "gp": asks.shape[0],
                  "live_groups": live_groups,
                  "max_count": kw["max_count"]},
    }


def k2_bytes(used, idx, donate: bool) -> int:
    """The bytes K2's function must move: the indices, the winning
    pair's row for each distinct kept index and those rows written; not
    donated, also the src rows no pair overwrites read and every dst row
    written. Dropped pairs' rows and losing duplicates' rows are not
    needed."""
    row = used.shape[1] * used.element_size()
    j, _ = tk._kept_rows(idx, used.shape[0])
    distinct = int(torch.unique(j).numel())
    if donate:
        return nbytes(idx) + 2 * row * distinct
    return (nbytes(idx) + row * distinct
            + row * (used.shape[0] - distinct) + row * used.shape[0])


def hold_k2(used, idx, rows, donate: bool) -> dict:
    """One K2 call (donated or not) against its twin (exact), then timed
    beside index_copy_ / index_copy on the kept pairs."""
    got = tk.scatter_rows(used.clone(), idx, rows, donate)
    want = tk.scatter_rows_plain(used.clone(), idx, rows, donate)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ik, kept = tk._kept_rows(idx, used.shape[0])
    rk = rows[kept]
    work = used.clone()
    ms, enq = device_ms(lambda: tk.scatter_rows(work, idx, rows, donate),
                        50)
    plain_ms = time_ms(
        lambda: tk.scatter_rows_plain(work, idx, rows, donate), 20)
    if donate:
        lib_ms, _ = device_ms(lambda: work.index_copy_(0, ik, rk), 50)
    else:
        lib_ms, _ = device_ms(lambda: used.index_copy(0, ik, rk), 50)
    return {"max_abs_err": err, "ms": ms, "enqueue_ms": enq,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "nbytes": k2_bytes(used, idx, donate),
            "shape": {"np": used.shape[0], "rows": idx.shape[0],
                      "kept": int(kept.sum())}}


def hold_k3(used, idx, rows) -> dict:
    """One K3 call against its twin (exact), then timed."""
    got = tk.scatter_add_rows(used, idx, rows)
    want = tk.scatter_add_rows_plain(used, idx, rows)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ms, enq = device_ms(lambda: tk.scatter_add_rows(used, idx, rows), 50)
    plain_ms = time_ms(lambda: tk.scatter_add_rows_plain(used, idx, rows),
                       20)
    return {"max_abs_err": err, "ms": ms, "enqueue_ms": enq,
            "plain_ms": plain_ms,
            "nbytes": nbytes(used, idx, rows) + nbytes(used),
            "shape": {"np": used.shape[0], "rows": idx.shape[0],
                      "kept": int(((idx >= 0)
                                   & (idx < used.shape[0])).sum())}}


def bound(nbytes_: int, ops: int) -> dict:
    t_bytes = 1e3 * nbytes_ / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def server_recorders() -> dict:
    """Recorders for the server phase's kernel calls: K1's, K2's first
    donated and first non-donated, and K3's."""
    return {
        "solve_placement_compact": Recorder(solver_mod,
                                            "solve_placement_compact"),
        "scatter_rows": Recorder(solver_mod, "scatter_rows",
                                 keep=lambda a: a[3] is True),
        "scatter_rows_copy": Recorder(solver_mod, "scatter_rows",
                                      keep=lambda a: a[3] is False),
        "scatter_add_rows": Recorder(solver_mod, "scatter_add_rows"),
    }


def replay_server(srec: dict, launches: dict) -> dict:
    """The server phase's first call of K1, K2 (donated, and not donated
    when that mode ran) and K3 against its twin, exact, then timed
    beside its bound: {kernel name: numbers at the server's shapes}."""
    held = {}
    for name, r in srec.items():
        if name == "scatter_rows_copy" and launches[name] == 0:
            continue
        check(r.first is not None, f"no server-path {name} call recorded")
        args, kw = r.first
        if name == "solve_placement_compact":
            h = hold_k1(args, kw)
        elif name.startswith("scatter_rows"):
            h = hold_k2(*args[:4])
        else:
            h = hold_k3(*args[:3])
        check(h["max_abs_err"] == 0, f"server-path {name} call differs")
        h.update(bound(h.pop("nbytes"), h.pop("ops", 0)))
        held[name] = h
    return held


class ShapeLog(Recorder):
    """A Recorder that also logs every K1 call's shape."""

    def __init__(self, mod, name: str) -> None:
        super().__init__(mod, name)
        self.shapes = []

    def __call__(self, *args, **kwargs):
        cap, asks, counts = args[0], args[2], args[3]
        self.shapes.append((int(cap.shape[0]), int(asks.shape[0]),
                            int((counts > 0).sum()),
                            int(kwargs.get("max_count", 0))))
        return super().__call__(*args, **kwargs)


def client_recorders() -> dict:
    """server_recorders with K1's recorder logging every call's shape."""
    recs = server_recorders()
    recs["solve_placement_compact"].restore()
    recs["solve_placement_compact"] = ShapeLog(solver_mod,
                                               "solve_placement_compact")
    return recs



# ---------------------------------------------------------------------------
# the solver pool: the leader's batch worker dispatches every batch to warm
# members over real sockets (fabric + gossip + pool, wired the way
# nomad_tpu's ClusterServer.__init__ wires them, cluster.py:1299-1322)
# ---------------------------------------------------------------------------

POOL_SECRET = "chip-smoke-pool"
# the port has no raft replication yet: every member's host reads the
# leader's own store, the perfectly synced replica of bench.py's c2m_pool
# (POOL_CAVEAT_TEXT, bench.py:1872)
POOL_CAVEAT = ("members read the leader's store: perfectly synced "
               "replicas, as bench.py's c2m_pool")
# the leader's batch traces with the members' segments merged in
POOL_SPANS = SERVER_SPANS + ("solver.pool.dispatch", "rpc.call",
                             "solver.pool.remote")
# bench.py run_c2m_pool_config's shapes (BENCH_POOL_NODES/JOBS/COUNT/
# BATCHES/PAIRS), without its injected 0.8 s device latency
POOL_SCALING = {"nodes": 2000, "jobs": 8, "count": 100, "batches": 6,
                "pairs": 2}
# which pool member the calling thread is solving for (PoolRecorder)
_POOL_MEMBER = threading.local()


class PoolNode:
    """One in-process cluster node: an RPCServer on 127.0.0.1 with the
    shared secret, a ConnPool, a Membership joined by gossip and a
    SolverPool (role "solver" advertises the serf tag solver=1). `host`
    owns the state store and the scheduler config the member's device
    comes from."""

    def __init__(self, node_id: str, host, role: str = "") -> None:
        from nomad_tpu_torch.rpc import ConnPool, RPCServer
        from nomad_tpu_torch.server.membership import Membership
        from nomad_tpu_torch.server.solver_pool import SolverPool

        self.node_id, self.server = node_id, host
        self.rpc = RPCServer(host="127.0.0.1", secret=POOL_SECRET)
        self.rpc.chaos_label = node_id
        self.pool = ConnPool(secret=POOL_SECRET)
        self.pool.owner = node_id
        self.serf = Membership(
            node_id, self.rpc.addr, pool=self.pool,
            tags={"role": "server"}, on_event=self._on_member_event)
        self.rpc.register("Serf", self.serf.endpoint)
        self.solver_pool = SolverPool(self, role=role)
        self.rpc.register("SolverPool", self.solver_pool.endpoint)
        self.rpc.start()
        self.serf.start()
        self.solver_pool.start()

    def _on_member_event(self, kind, member) -> None:
        self.solver_pool.on_member_event(kind, member)

    def solver(self):
        return self.solver_pool.endpoint.local_solver(build=False)

    def shutdown(self) -> None:
        self.solver_pool.stop()
        self.serf.stop()
        self.rpc.shutdown()
        self.pool.shutdown()


def tag_member(node: PoolNode) -> None:
    """Mark the member's solves and syncs with its id on the calling
    thread, so a PoolRecorder keeps each member's first calls apart."""
    rs = node.solver()

    def tagged(fn):
        def call(*args, **kwargs):
            _POOL_MEMBER.id = node.node_id
            try:
                return fn(*args, **kwargs)
            finally:
                _POOL_MEMBER.id = None
        return call

    rs.solve, rs.warm = tagged(rs.solve), tagged(rs.warm)


class PoolRecorder(Recorder):
    """A Recorder that keeps the first accepted call per pool member."""

    def __init__(self, mod, name: str, keep=None) -> None:
        super().__init__(mod, name, keep)
        self.first_by = {}

    def __call__(self, *args, **kwargs):
        member = getattr(_POOL_MEMBER, "id", None)
        if (member is not None and member not in self.first_by
                and (self.keep is None or self.keep(args))):
            self.first_by[member] = (
                [a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args], dict(kwargs))
        return super().__call__(*args, **kwargs)


def pool_recorders() -> dict:
    return {
        "solve_placement_compact": PoolRecorder(solver_mod,
                                                "solve_placement_compact"),
        "scatter_rows": PoolRecorder(solver_mod, "scatter_rows",
                                     keep=lambda a: a[3] is True),
        "scatter_rows_copy": PoolRecorder(solver_mod, "scatter_rows",
                                          keep=lambda a: a[3] is False),
    }


def pool_cluster(device: str, nodes: list, n_members: int,
                 pipeline: bool = True, leader: bool = True) -> dict:
    """The port's Server (start_server: the GPU batch worker, batches of
    SERVER_BATCH) as the pool's leader, and n_members solver-role members
    whose hosts share its store, joined by gossip; the worker's
    solver_pool is the leader's tracker. Each member is warmed once
    through SolverPool.Sync over RPC."""
    srv, _ = start_server(device, nodes, pipeline=pipeline, leader=leader)
    lead = PoolNode("leader", srv)
    members = [
        PoolNode(f"m{i}", types.SimpleNamespace(
            state=srv.state,
            scheduler_config=SchedulerConfig(device=device)),
            role="solver")
        for i in range(n_members)
    ]
    for m in members:
        check(m.serf.join([lead.rpc.addr]) == 1, f"{m.node_id} did not join")
    deadline = time.monotonic() + 30
    while len([r for r in lead.solver_pool.members()
               if r["status"] == "alive" and not r["self"]]) < n_members:
        check(time.monotonic() < deadline,
              "the pool members never became alive at the leader")
        time.sleep(0.02)
    for m in members:
        lead.pool.call(m.rpc.addr, "SolverPool.Sync",
                       {"min_index": srv.state.latest_index()},
                       timeout_s=300)
        tag_member(m)
    srv.tpu_worker.solver_pool = lead.solver_pool
    return {"srv": srv, "leader": lead, "members": members}


def pool_shutdown(pc: dict) -> None:
    pc["srv"].shutdown()
    for node in pc["members"] + [pc["leader"]]:
        node.shutdown()


def pool_numbers(pc: dict, before: dict, after: dict, traces: list,
                 wall: float, n_jobs: int, n_allocs: int) -> dict:
    """wave_numbers plus the pool's: dispatches, faults, local
    fallbacks, the request and reply bytes per batch, the summed pool
    spans, and each member's solves, syncs and warmups."""
    def count(name):
        return (after["counters"].get(name, 0)
                - before["counters"].get(name, 0))

    out = wave_numbers(before, after, traces, wall, n_jobs, n_allocs)
    # a member's segment records device.wait once per K1 launch, a
    # spread-relaxation retry's included
    out["compact_batches"] = sum(
        1 for t in traces for sp in t.spans if sp.name == "device.wait")
    out["spans_ms"] = span_sums_ms(traces, POOL_SPANS)
    sent = count("nomad.rpc.sent_bytes.SolverPool.Solve")
    reply = count("nomad.rpc.reply_bytes.SolverPool.Solve")
    dispatched = count("nomad.solver.pool.dispatched")
    out.update({
        "dispatched": dispatched,
        "member_faults": count("nomad.solver.pool.member_fault"),
        "fallback_local": count("nomad.solver.pool.fallback_local"),
        "request_bytes_per_batch": sent / max(dispatched, 1),
        "reply_bytes_per_batch": reply / max(dispatched, 1),
        "members": {m.node_id: m.solver().stats() for m in pc["members"]},
    })
    return out


def pool_c2m(device: str, n_nodes: int, n_jobs: int, count: int,
             on_phase) -> dict:
    """c2m's fleet and jobs through Server.job_register on the leader,
    then the server phase's roll wave, every batch solved by one of two
    warm members over RPC. Launch counters zeroed just before the first
    register and read after the roll wave. Returns the cluster (left
    running for pool.failover), the launches and the numbers."""
    from nomad_tpu_torch import metrics
    from nomad_tpu_torch.metrics import Registry

    metrics._install_registry(Registry())
    trace.clear_finished()
    pc = pool_cluster(device, c2m_nodes(n_nodes), 2)
    srv = pc["srv"]
    tk.reset_launch_counts()
    m0 = metrics.snapshot()
    jobs = [make_job(f"pool-{j}", count) for j in range(n_jobs)]
    wall1 = register_and_wait(srv, jobs)
    check_server_state(srv, n_jobs * count)
    m1 = metrics.snapshot()
    c2m = pool_numbers(pc, m0, m1, batch_traces(), wall1, n_jobs,
                       n_jobs * count)
    on_phase("pool.c2m.wave", wall1, caveat=POOL_CAVEAT, **c2m)
    traces = batch_traces()
    trace.clear_finished()
    roll = [make_job(f"pool-roll-{j}", count)
            for j in range(SERVER_ROLL_NEW)]
    for k, at in enumerate(SERVER_ROLL_AT):
        stored = srv.state.job_by_id(jobs[k].namespace, jobs[k].id)
        roll.insert(at, rolled(stored, count // 2))
    wall2 = register_and_wait(srv, roll)
    want_live = (n_jobs * count - len(SERVER_ROLL_AT) * (count - count // 2)
                 + SERVER_ROLL_NEW * count)
    check_server_state(srv, want_live)
    launches = launch_counts()
    m2 = metrics.snapshot()
    rollw = pool_numbers(pc, m1, m2, batch_traces(), wall2, len(roll),
                         SERVER_ROLL_NEW * count
                         + len(SERVER_ROLL_AT) * (count // 2))
    on_phase("pool.c2m.roll", wall2, **rollw)
    traces += batch_traces()
    whole = pool_numbers(pc, m0, m2, traces, wall1 + wall2, 0, 0)
    return {"pc": pc, "live": want_live, "launches": launches,
            "counters": m2["counters"], "whole": whole,
            "numbers": {"wall_s": wall1, "jobs_per_s": n_jobs / wall1,
                        "allocs_per_s": n_jobs * count / wall1,
                        "roll_wall_s": wall2,
                        "partial_commits": whole["partial_commits"],
                        "compact_batches": whole["compact_batches"],
                        "dispatched": whole["dispatched"],
                        "spans_ms": whole["spans_ms"],
                        "request_bytes_per_batch":
                            whole["request_bytes_per_batch"],
                        "reply_bytes_per_batch":
                            whole["reply_bytes_per_batch"]}}


def check_pool(res, device: str) -> None:
    """Every batch on a member: no local fallback, no fault, no
    failover; each member warmed once and solved; its resident tensors
    on the card; K1 launched once per compact solve on a member."""
    c, w = res["counters"], res["whole"]
    check(w["fallback_local"] == 0,
          f"{w['fallback_local']} batches fell back to the leader")
    check(w["member_faults"] == 0, f"{w['member_faults']} member faults")
    check(c.get("nomad.worker.device_failover", 0) == 0,
          "a device failover in a phase that injects nothing")
    check(c.get("nomad.worker.invoke.failed", 0) == 0,
          "a batch failed to solve or commit")
    check(w["dispatched"] == w["batches"],
          f"{w['dispatched']} dispatches for {w['batches']} batches")
    srv = res["pc"]["srv"]
    check(srv.tpu_worker._resident is None,
          "the leader solved a batch on its own card")
    want = torch.device("cuda", 0) if device == "cuda" else \
        torch.device("cpu")
    for m in res["pc"]["members"]:
        st = m.solver().stats()
        check(st["warmups"] == 1 and st["solves"] >= 1,
              f"member {m.node_id}: {st}")
        r = m.solver()._resident
        check(r._cap_dev.device == want and r._used_dev.device == want,
              f"member {m.node_id}'s resident tensors are not on {want}")
    if device == "cuda":
        k1 = res["launches"]["solve_placement_compact"]
        check(k1 == w["compact_batches"] and k1 > 0,
              f"K1 ran {k1} times for {w['compact_batches']} compact "
              "solves on the members")
        check(res["launches"]["scatter_rows_copy"] >= 1,
              "K2's non-donated mode was not launched in the pool phase")


def pool_failover(pc: dict, live: int, n_jobs: int = 24,
                  count: int = 50) -> dict:
    """A faultplane drop on one member's SolverPool.Solve (both of the
    ConnPool's attempts of one call): that batch is exactly one member
    fault and one device_failover, re-solved by solve_host_fallback;
    every batch picked while the failing member cools (FAULT_COOLDOWN_S
    from its fault) goes to the surviving member; every alloc placed.
    A run that outlasts the cooldown may route later batches back to
    the healed member: they must then solve there without a fault. Each
    pick is timed around SolverPool._pick: a pick counts as made while
    cooling when its whole window lies inside the cooldown, and a pick
    of the failing member as healed when it ends after the cooldown.
    The worker restarts unpipelined first: a pipelined solve stage can
    dispatch its next batch before the failing call's thread records
    the fault, and pick the failing member again when both are busy."""
    from nomad_tpu_torch import faultplane, metrics
    from nomad_tpu_torch.server.solver_pool import (
        FAULT_COOLDOWN_S, RemotePendingBatch,
    )

    srv, lead = pc["srv"], pc["leader"]
    w = srv.tpu_worker
    w.stop()
    w.pipeline = False
    w.start()
    pool = lead.solver_pool
    victim = pool._pick()[0]
    survivor = [m.node_id for m in pc["members"] if m.node_id != victim][0]
    before = pool.stats_snapshot()
    rows0 = {r["id"]: r for r in before["members"]}
    calls = []
    picks = []  # (member id or None, monotonic before, monotonic after)
    real = RemotePendingBatch.solve_host_fallback
    real_pick = pool._pick

    def counted(self):
        calls.append(len(self._evals))
        return real(self)

    def timed_pick():
        t0 = time.monotonic()
        got = real_pick()
        picks.append((got and got[0], t0, time.monotonic()))
        return got

    m0 = metrics.snapshot()["counters"]
    RemotePendingBatch.solve_host_fallback = counted
    pool._pick = timed_pick
    plane = faultplane.install(faultplane.FaultPlane(seed=0))
    for node in [lead] + pc["members"]:
        plane.register_addr(node.node_id, node.rpc.addr)
    plane.drop_rpc(dst=victim, method="SolverPool.Solve", times=2)
    try:
        jobs = [make_job(f"pool-fo-{j}", count, constrained=False)
                for j in range(n_jobs)]
        wall = register_and_wait(srv, jobs)
    finally:
        faultplane.uninstall()
        RemotePendingBatch.solve_host_fallback = real
        del pool._pick
    m1 = metrics.snapshot()["counters"]
    after = pool.stats_snapshot()
    rows1 = {r["id"]: r for r in after["members"]}
    faults = after["faults"] - before["faults"]
    failovers = (m1.get("nomad.worker.device_failover", 0)
                 - m0.get("nomad.worker.device_failover", 0))
    to_victim = rows1[victim]["dispatched"] - rows0[victim]["dispatched"]
    to_survivor = (rows1[survivor]["dispatched"]
                   - rows0[survivor]["dispatched"])
    check(faults == 1, f"{faults} member faults, want exactly 1")
    check(failovers == 1, f"{failovers} device failovers, want exactly 1")
    check(len(calls) == 1, f"solve_host_fallback ran {len(calls)} times")
    fault_until = pool._fault_until[victim]
    fault_at = fault_until - FAULT_COOLDOWN_S
    at_victim = [(t0, t1) for mid, t0, t1 in picks if mid == victim]
    pre_fault = sum(t1 <= fault_at for _, t1 in at_victim)
    healed = sum(t1 >= fault_until for _, t1 in at_victim)
    while_cooling = [mid for mid, t0, t1 in picks
                     if t0 >= fault_at and t1 < fault_until]
    check(to_victim == len(at_victim),
          f"{to_victim} dispatches to the failing member, "
          f"{len(at_victim)} picks of it")
    check(to_survivor == sum(mid == survivor for mid, _, _ in picks),
          f"{to_survivor} dispatches to the surviving member do not match "
          "its picks")
    check(pre_fault == 1,
          f"{pre_fault} batches went to the failing member before its fault")
    check(all(mid == survivor for mid in while_cooling),
          f"picks while the failing member cooled: {while_cooling}")
    check(pre_fault + healed == len(at_victim),
          "a pick of the failing member fell inside its cooldown")
    check(to_survivor >= 1 or not while_cooling,
          "no later batch went to the surviving member")
    check(after["fallback_local"] == before["fallback_local"],
          "a batch fell back to the leader's own solve")
    check_server_state(srv, live + n_jobs * count)
    return {"wall_s": wall, "victim": victim, "member_faults": faults,
            "failovers": failovers, "fallback_evals": calls[0],
            "to_survivor": to_survivor, "to_victim_after_cooldown": healed,
            "picks_while_cooling": len(while_cooling),
            "cooldown_s": FAULT_COOLDOWN_S, "rpc_drops": plane.fired}


def pool_lockstep(device: str, n_nodes: int, n_jobs: int, count: int,
                  n_batches: int) -> dict:
    """One member, the worker driven by hand: each of c2m's first
    n_batches batches is solved on one snapshot on the leader's own card
    (solve_eval_batch_begin on the worker's resident state) and through
    the member over RPC (SolverPool.dispatch_batch), before the commit;
    the local plans are then committed. Returns the placements of each
    side by (job, alloc name, node), per batch."""
    from nomad_tpu_torch.scheduler.gpu import solve_eval_batch_begin
    from nomad_tpu_torch.scheduler.gpu.remote_solve import CollectingPlanner

    pc = pool_cluster(device, c2m_nodes(n_nodes), 1, leader=False)
    srv = pc["srv"]
    w = srv.tpu_worker
    w.solver_pool = None
    sides = {"local": [], "member": []}
    try:
        for j in range(n_jobs):
            srv.job_register(make_job(f"pool-lock-{j}", count))
        for _ in range(n_batches):
            batch = []
            while len(batch) < SERVER_BATCH:
                ev, tok = srv.eval_broker.dequeue(["service"], timeout_s=1)
                check(ev is not None, "the broker ran dry")
                batch.append((ev, tok))
            evals = [e for e, _ in batch]
            snap = srv.state.snapshot()
            remote = pc["leader"].solver_pool.dispatch_batch(
                evals, snap, CollectingPlanner(), w.config)
            check(remote is not None, "no pool member to dispatch to")
            w._ensure_resident()
            local = solve_eval_batch_begin(
                snap, CollectingPlanner(), evals, w.config,
                resident=w._resident)
            for side, pending in (("member", remote), ("local", local)):
                sides[side].append(sorted(
                    (a.job_id, a.name, a.node_id)
                    for p in pending.finish().values()
                    for a in ([a for al in p.node_allocation.values()
                               for a in al]
                              + [a for b in p.alloc_batches
                                 for a in b.materialize()])))
            w._commit(batch, local, snap, threading.Event(), {"ok": None},
                      None)
    finally:
        pool_shutdown(pc)
    return sides


def pool_scaling(device: str, cfg: dict = POOL_SCALING) -> dict:
    """bench.py run_c2m_pool_config's shapes through the pool: per trial
    a fresh leader and 1 or 2 fresh members (2,000 nodes), one
    unmeasured warm wave of 8 jobs x 100 per member, then 6 batches of 8
    jobs x 100 registered at once; committed evals/s over that window.
    Pool sizes 1 and 2 interleaved 1, 2, 2, 1 (ABBA). Returns the rates
    and the ratio, a number to record, not a gate: bench.py's 1.5x gate
    belongs to its injected-latency device model, and these members
    share one card and one interpreter."""
    order = []
    for p in range(cfg["pairs"]):
        order.extend((1, 2) if p % 2 == 0 else (2, 1))
    rates = {1: [], 2: []}
    for t, size in enumerate(order):
        pc = pool_cluster(device, c2m_nodes(cfg["nodes"]), size)
        srv = pc["srv"]
        try:
            register_and_wait(srv, [
                make_job(f"sc{t}-w{j}", cfg["count"], constrained=False)
                for j in range(cfg["jobs"] * size)])
            jobs = [make_job(f"sc{t}-{j}", cfg["count"], constrained=False)
                    for j in range(cfg["jobs"] * cfg["batches"])]
            wall = register_and_wait(srv, jobs)
            check(all(m.solver().stats()["warmups"] == 1
                      for m in pc["members"]),
                  "a pool member warmed more than once")
            rates[size].append(len(jobs) / wall)
        finally:
            pool_shutdown(pc)
    med = {s: statistics.median(r) for s, r in rates.items()}
    return {"evals_per_s": {str(s): r for s, r in rates.items()},
            "median_evals_per_s": {str(s): v for s, v in med.items()},
            "ratio_2_over_1": med[2] / med[1], "order": order,
            "caveat": POOL_CAVEAT}


def replay_pool(prec: dict, n_members: int) -> dict:
    """Each member's first K1 call, first donated K2 call (its delta
    sync) and, where it ran, first non-donated K2 call (a batch's stops)
    against its twin, exact, then timed beside its bound: {kernel name:
    {member: numbers}}."""
    held = {}
    for name, r in prec.items():
        for member, (args, kw) in sorted(r.first_by.items()):
            if name == "solve_placement_compact":
                h = hold_k1(args, kw)
            else:
                h = hold_k2(*args[:4])
            check(h["max_abs_err"] == 0,
                  f"member {member}'s first {name} call differs")
            h.update(bound(h.pop("nbytes"), h.pop("ops", 0)))
            held.setdefault(name, {})[member] = h
    for name in ("solve_placement_compact", "scatter_rows"):
        check(len(held.get(name, {})) == n_members,
              f"not every member's first {name} call was recorded")
    check(len(held.get("scatter_rows_copy", {})) >= 1,
          "no member's non-donated K2 call was recorded")
    return held


# ---------------------------------------------------------------------------
# the wire codec: one solver-pool reply at c2m's width through the C
# fastpack (native/fastpack.c pack and unpack) and the Python twins
# ---------------------------------------------------------------------------

# one pool member's reply: RemoteSolver.solve of one batch of 8 of c2m's
# jobs on c2m's 10,000 nodes
CODEC = {"nodes": 10000, "jobs": 8, "count": 1000}


def codec_phase(device: str, cfg: dict = CODEC) -> dict:
    """One solver-pool reply as a member sends it: the port's Server
    (not led) takes cfg["jobs"] of c2m's jobs through job_register, and a
    RemoteSolver on the leader's store solves their evals in one batch,
    every batch on the card (small_batch_threshold 0), launch counters
    zeroed just before the solve and read just after. The reply goes
    through codec.pack and unpack (C), timed; the C bytes must equal the
    Python writer's, the bytes must pack again to themselves after the
    round trip, one PlacementBatch's bytes must decode to the same wire
    form through C and the Python reader, and every fastpack entry point
    must be live. Returns the numbers, the launches and K1's first call
    held against its twin."""
    from nomad_tpu_torch import codec, native
    from nomad_tpu_torch.scheduler.gpu.remote_solve import RemoteSolver
    from nomad_tpu_torch.structs.placement_batch import PlacementBatch

    check(codec.warm_native(),
          f"the C fastpack is not live: {native.last_error}")
    fp = codec.native_module()
    missing = [n for n in native.FASTPACK_ENTRY_POINTS
               if not callable(getattr(fp, n, None))]
    check(not missing, f"fastpack entry points missing: {missing}")
    srv, _ = start_server(device, c2m_nodes(cfg["nodes"]), leader=False,
                          small_batch_threshold=0)
    rec = Recorder(solver_mod, "solve_placement_compact")
    try:
        for j in range(cfg["jobs"]):
            srv.job_register(make_job(f"codec-{j}", cfg["count"]))
        evals = []
        while len(evals) < cfg["jobs"]:
            ev, _tok = srv.eval_broker.dequeue(["service"], timeout_s=1)
            check(ev is not None, "the broker ran dry")
            evals.append(ev)
        member = RemoteSolver(types.SimpleNamespace(state=srv.state),
                              card_solve_config(device), node_id="codec")
        tk.reset_launch_counts()
        reply = member.solve(evals, srv.state.latest_index())
        launches = launch_counts()
    finally:
        rec.restore()
        srv.shutdown()
    check(launches["solve_placement_compact"] > 0,
          "K1 was not launched for the pool reply")
    check(rec.first is not None, "no codec-path K1 call recorded")
    held = hold_k1(*rec.first)
    check(held["max_abs_err"] == 0, "the codec path's K1 call differs")
    held.update(bound(held.pop("nbytes"), held.pop("ops")))
    batches = [b for p in reply["plans"].values() for b in p.alloc_batches]
    placed = sum(len(b) for b in batches)
    check(placed == cfg["jobs"] * cfg["count"],
          f"the reply places {placed}, want {cfg['jobs'] * cfg['count']}")

    t0 = time.perf_counter()
    raw = codec.pack(reply)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = codec.unpack(raw)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_raw = codec._pack_py(codec.to_wire(reply, _elide=True))
    py_encode_s = time.perf_counter() - t0
    check(raw == py_raw, "the C pack's bytes differ from the Python "
          "writer's")
    check(codec.pack(back) == raw,
          "the reply does not pack to the same bytes after unpack")
    one = codec.pack(batches[0])
    t0 = time.perf_counter()
    c_one = fp.unpack(one)
    c_slice_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_one = codec._unpack_py(one)
    py_slice_s = time.perf_counter() - t0
    check(isinstance(c_one, PlacementBatch)
          and codec.to_wire(c_one) == codec.to_wire(py_one)
          == codec.to_wire(batches[0]),
          "the C unpack and the Python reader disagree on a "
          "PlacementBatch")
    return {"launches": launches, "k1": held, "numbers": {
        "reply_bytes": len(raw), "encode_s": encode_s,
        "decode_s": decode_s, "py_encode_s": py_encode_s,
        "batches": len(batches), "allocs": placed,
        "slice_bytes": len(one), "slice_decode_s": c_slice_s,
        "slice_py_decode_s": py_slice_s,
        "entry_points": list(native.FASTPACK_ENTRY_POINTS)}}


def replay(rec: dict, launches: dict, drain_rec, dev, seed: int) -> list:
    """Each kernel's first main-path call against its twin, then timed;
    K2's non-donated mode also on the drain path's first such call and on
    scatter_set_cases' edges."""
    out = []
    # K1
    k1 = hold_k1(*rec["solve_placement_compact"].first)
    check(k1["max_abs_err"] == 0, "main-path compact call differs")
    out.append(entry("solve_placement_compact", launches, k1["max_abs_err"],
                     k1["ms"], k1["plain_ms"], k1["nbytes"], k1["ops"], None,
                     enqueue_ms=k1["enqueue_ms"], launch=k1["launch"],
                     shape=k1["shape"]))
    # K2: the delta sync (donated) and the adjusted view (not donated),
    # at the main path's first call (8192 pairs) and at the drain path's
    args2, _ = rec["scatter_rows"].first
    used2, idx2, rows2 = args2[:3]
    k2_err = 0.0
    for donate in (True, False):
        got = tk.scatter_rows(used2.clone(), idx2, rows2, donate)
        want = tk.scatter_rows_plain(used2.clone(), idx2, rows2, donate)
        torch.cuda.synchronize()
        k2_err = max(k2_err, max_abs_err(got, want))
    check(k2_err == 0, "main-path scatter_rows differs")
    used_d, idx_d, rows_d = drain_rec.first[0][:3]
    path_calls = [("replay", used2.cpu(), idx2.cpu(), rows2.cpu()),
                  ("drain", used_d.cpu(), idx_d.cpu(), rows_d.cpu())]
    n_cases = scatter_set_checks(dev, np.random.default_rng(seed + 2),
                                 path_calls)

    def copy_numbers(used, idx, rows) -> dict:
        """Non-donated K2 at one shape: device and enqueue time, bound,
        and index_copy out of place (one PyTorch call, same function for
        distinct indices) timed the same way."""
        ik, keep = tk._kept_rows(idx, used.shape[0])
        rk = rows[keep]
        ms_, enq_ = device_ms(
            lambda: tk.scatter_rows(used, idx, rows, False), 50)
        lib_, _ = device_ms(lambda: used.index_copy(0, ik, rk), 50)
        return {"ms": ms_, "enqueue_ms": enq_, "library_ms": lib_,
                "bound_ms": 1e3 * k2_bytes(used, idx, False)
                / HBM_BYTES_PER_S,
                "shape": {"np": used.shape[0], "rows": idx.shape[0],
                          "kept": int(keep.sum())}}

    ik, kept = tk._kept_rows(idx2, used2.shape[0])
    b_kept = int(kept.sum())
    work = used2.clone()
    ms, enq = device_ms(lambda: tk.scatter_rows(work, idx2, rows2, True), 50)
    copy_replay = copy_numbers(used2, idx2, rows2)
    copy_drain = copy_numbers(used_d, idx_d, rows_d)
    plain_ms = time_ms(
        lambda: tk.scatter_rows_plain(work, idx2, rows2, True), 20
    )
    rk = rows2[kept]
    lib_ms, _ = device_ms(lambda: work.index_copy_(0, ik, rk), 50)
    out.append(entry("scatter_rows", launches, k2_err, ms, plain_ms,
                     k2_bytes(used2, idx2, True),
                     0, lib_ms, enqueue_ms=enq, ms_copy=copy_replay["ms"],
                     enqueue_ms_copy=copy_replay["enqueue_ms"],
                     bound_ms_copy=copy_replay["bound_ms"],
                     library_ms_copy=copy_replay["library_ms"],
                     copy_at_drain_shape=copy_drain,
                     launches_copy_drain=launches["scatter_rows_copy"],
                     set_cases_checked=n_cases,
                     shape={"np": used2.shape[0], "rows": idx2.shape[0],
                            "kept": b_kept}))
    # K3: the stops' deltas onto the chained used'
    k3 = hold_k3(*rec["scatter_add_rows"].first[0][:3])
    check(k3["max_abs_err"] == 0, "main-path scatter_add_rows differs")
    out.append(entry("scatter_add_rows", launches, k3["max_abs_err"],
                     k3["ms"], k3["plain_ms"], k3["nbytes"], 0, None,
                     enqueue_ms=k3["enqueue_ms"], shape=k3["shape"]))
    return out


def replay_dense(rec: dict, launches: dict, k4_placing: list) -> list:
    """K5's and K4's first preempt-path calls against their twins, then
    timed. The operation count is what this run's data needs: one
    scoring pass per live group, and a second for each group whose
    phase 1 left a remainder. K4's call on the path places nothing (K5
    left no free slot), so K4 is also timed on kernel_checks' random
    case, which places, under `placing_case`."""
    out = []
    args, _ = rec["solve_placement_preempt"].first
    got = tk.solve_placement_preempt(*args)
    want = tk.solve_placement_preempt_plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, "preempt-path solve_placement_preempt call differs")
    cap, _, prefix, asks, counts = args[:5]
    assign, evict, _ = got
    live = counts > 0
    phase2 = live & ((assign - evict).sum(dim=1) < counts)
    np_ = cap.shape[0]
    ops = (int(live.sum()) + int(phase2.sum())) * np_ * SCORE_FLOPS
    ms, enq = device_ms(lambda: tk.solve_placement_preempt(*args), 10)
    plain_ms = time_ms(lambda: tk.solve_placement_preempt_plain(*args), 3)
    split = device_split_ms(lambda: tk.solve_placement_preempt(*args))
    check(list(split) == ["solve_placement_kernel"],
          f"K5 did not run the radix-select kernel alone: {split}")
    out.append(entry("solve_placement_preempt", launches, err, ms, plain_ms,
                     nbytes(*args, *got), ops, None, enqueue_ms=enq,
                     launch=tk.solve_placement_preempt.last_launch,
                     kernel_split_ms=split,
                     shape={"np": np_, "gp": asks.shape[0],
                            "tp": prefix.shape[0],
                            "live_groups": int(live.sum()),
                            "phase2_groups": int(phase2.sum()),
                            "placed": int(assign.sum()),
                            "evicting": int(evict.sum())}))
    k4 = []
    for args in (rec["solve_placement"].first[0], k4_placing):
        got = tk.solve_placement(*args)
        launch = dict(tk.solve_placement.last_launch)
        want = tk.solve_placement_plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, "solve_placement call differs from its twin")
        cap, _, asks, counts = args[:4]
        live = int((counts > 0).sum())
        ms, enq = device_ms(lambda: tk.solve_placement(*args), 10)
        plain_ms = time_ms(lambda: tk.solve_placement_plain(*args), 3)
        split = device_split_ms(lambda: tk.solve_placement(*args))
        check(list(split) == ["solve_placement_kernel"],
              f"K4 did not run the radix-select kernel alone: {split}")
        k4.append(entry("solve_placement", launches, err, ms, plain_ms,
                        nbytes(*args, *got),
                        live * cap.shape[0] * SCORE_FLOPS, None,
                        enqueue_ms=enq, launch=launch, kernel_split_ms=split,
                        shape={"np": cap.shape[0], "gp": asks.shape[0],
                               "live_groups": live,
                               "placed": int(got[0].sum())}))
    path, placing = k4
    check(placing["shape"]["placed"] > 0, "K4's timed case placed nothing")
    path["placing_case"] = {k: placing[k] for k in (
        "max_abs_err", "ms", "enqueue_ms", "plain_ms", "bound_ms",
        "bound_by", "launch", "shape")}
    out.append(path)
    return out


def device_split_ms(fn) -> dict:
    """Device milliseconds by kernel over one call, from torch.profiler's
    CUDA activity (kernel names cut to their __global__ function). A
    capture that recorded no kernel at all is taken again, up to three
    times: the profiler once returned no device activity for a 0.05 ms
    launch, which says nothing about which kernels ran."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out: dict = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            m = re.search(r"(\w+_kernel)", ev.key)
            if us and m:
                out[m.group(1)] = out.get(m.group(1), 0.0) + us / 1e3
        if out:
            break
    return out


def replay_mesh(paths: dict, launches: dict) -> list:
    """K6's and K7's first calls on the mesh's paths against their twins,
    then timed: `ms` is the device time of one whole call (every launch
    it makes, back to back), `launches_per_solve` the launches one call
    makes. The operation count is what this run's data needs, as for
    K1 and K5."""
    out = []
    for name in ("sharded_solver", "sharded_solver_preempt"):
        args, kw = paths[name]["rec"].first
        fn, plain = getattr(tk, name), getattr(tk, name + "_plain")
        before = fn.launches
        got = fn(*args, **kw)
        per_solve = fn.launches - before
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, f"mesh-path {name} call differs from its twin")
        if name == "sharded_solver":
            cap, _, asks, counts = args[:4]
            live = counts > 0
            passes = int(live.sum())
            shape = {"np": cap.shape[0], "gp": asks.shape[0],
                     "live_groups": passes, "shards": kw["n_shards"],
                     "max_count": kw["max_count"],
                     "compact": kw["compact"],
                     "placed": int((got[0] >= 0).sum())}
        else:
            cap, _, prefix, asks, counts = args[:5]
            assign, evict, _ = got
            live = counts > 0
            phase2 = live & ((assign - evict).sum(dim=1) < counts)
            passes = int(live.sum()) + int(phase2.sum())
            shape = {"np": cap.shape[0], "gp": asks.shape[0],
                     "tp": prefix.shape[0], "shards": kw["n_shards"],
                     "live_groups": int(live.sum()),
                     "phase2_groups": int(phase2.sum()),
                     "placed": int(assign.sum()),
                     "evicting": int(evict.sum())}
        # the calls queued behind the spin kernel must fit the card's
        # queue of pending launches (about a thousand), or the host blocks
        # until the spin ends: K6 makes 33 launches a call; a replay of
        # K7's graph queues one graph and its copies
        graph = name == "sharded_solver_preempt"
        reps = 5 if graph else max(1, min(5, 512 // per_solve))
        replays = tk.sharded_solver_preempt.graph_replays
        ms, enq = device_ms(lambda: fn(*args, **kw), reps)
        plain_ms = time_ms(lambda: plain(*args, **kw), 3)
        extra = {"kernel_split_ms": device_split_ms(lambda: fn(*args, **kw)),
                 "shard_cluster": libkernels.library().nomad_shard_cluster(
                     kw["n_shards"], cap.shape[0] // kw["n_shards"])}
        if graph:
            route = tk.sharded_solver_preempt.last_route
            check(route == "graph_replay",
                  f"K7's timed calls took the {route} route")
            split = extra["kernel_split_ms"]
            check("gathered_select_kernel" in split
                  and "gathered_waterfill_kernel" not in split,
                  f"K7 did not run the radix select alone: {split}")
            entry_ = tk.sharded_solver_preempt.graphs[
                (cap.shape[0], asks.shape[0], prefix.shape[0],
                 kw["n_shards"], cap.device.index)]
            replay_ms, replay_enq = device_ms(entry_["graph"].replay, reps)
            extra.update(
                launch_route=route,
                graph_replays=tk.sharded_solver_preempt.graph_replays
                - replays,
                graph_replays_on_path=paths[name]["graph_replays"],
                capture_s=paths[name]["capture_s"],
                graph_only_ms=replay_ms, graph_only_enqueue_ms=replay_enq,
                water_cluster=libkernels.library().nomad_water_cluster(
                    cap.shape[0]))
        if name == "sharded_solver":
            # the same call with every row in one shard
            one = dict(kw, n_shards=1)
            d1 = fn(*args, **one)
            torch.cuda.synchronize()
            check(max_abs_err(d1, got) == 0, "K6 on 1 shard differs from 8")
            d1_ms, d1_enq = device_ms(lambda: fn(*args, **one), reps)
            extra["one_shard"] = {
                "ms": d1_ms, "enqueue_ms": d1_enq,
                "shard_cluster": libkernels.library().nomad_shard_cluster(
                    1, cap.shape[0]),
                "kernel_split_ms": device_split_ms(lambda: fn(*args, **one)),
            }
        out.append(entry(name, launches, err, ms, plain_ms,
                         nbytes(*args, *got),
                         passes * cap.shape[0] * SCORE_FLOPS, None,
                         enqueue_ms=enq, launches_per_solve=per_solve,
                         solves_on_path=paths[name]["solves"],
                         timed_calls=reps, shape=shape, **extra))
    return out


def entry(name, launches, err, ms, plain_ms, nbytes_, ops, lib_ms, **extra):
    src, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[name], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, **bound(nbytes_, ops), "library_ms": lib_ms,
        **extra,
    }


# ---------------------------------------------------------------------------
# 13-16. the fleet, the soak, the scenarios and the lock-order detector:
# the harnesses of nomad_tpu_torch/testing at bench.py's settings, on the
# card, with every solve on it
# ---------------------------------------------------------------------------

# bench.py run_fleet_config (:1612) at c2m's 10,000 nodes: one server,
# TTL 10 s, 8 driver threads, 8 real watchers, a 20% partition, 10
# jobs/s, the register deadline max(60, n / 50), the p99 and cpu-per-node
# bounds; steady state cut from bench's 600 s to 60 s. Only batches of
# 8 or more placements go to the card (small_batch_threshold): with
# every batch on it (threshold 0) the reconnect storm did not settle in
# 240 s in 3 of 7 runs on an H100, its heartbeats stalled 8-16 s behind
# the 10 s TTL (PERF.md, open questions). At 8 it still failed so in
# about a third of the runs while the fleet's 8 driver threads made
# every register and heartbeat call themselves: the reconnect's 4,000
# raft-bound calls held all 8 past the TTL's slack. The calls now run on
# testing/fleet.py's RPC_WORKERS pool, and the server commits
# concurrent recoveries together (Server.ready_batcher). The fleet's own 2-alloc
# traffic then mostly takes the host route, so c2m's job (c2m_job
# allocs) is registered once the fleet is in, and its storms'
# re-placements, go to the card.
FLEET = {"nodes": 10000, "steady_s": 60.0, "ttl_s": 10.0, "drivers": 8,
         "watchers": 8, "fraction": 0.2, "rate": 10.0, "p99_s": 1.0,
         "cpu_per_node": 0.002, "seed": 42, "servers": 1,
         "small_batch_threshold": 8, "c2m_job": 1000}
# bench.py run_soak_config (:1509): 3 servers, 30 s at 120 evals/s
# offered, seed 42, admission depth 96 (namespace cap 48, blocked cap 96),
# RPC rate 40 / burst 80, the partition cycle, faults on, p99 bound 15 s
SOAK = {"duration_s": 30.0, "rate": 120.0, "seed": 42, "depth": 96,
        "rpc_rate": 40.0, "rpc_burst": 80.0, "p99_s": 15.0}
# tests/test_torch_scenarios.py's seeds and sizes
SCENARIOS = {"churn_seed": 31, "churn_cycles": 4, "pool_seed": 43}
# tests/test_torch_racecheck.py's pipeline case: 6 nodes, 4 jobs of 2,
# the modeled device round-trip widening the solve/commit overlap
RACE = {"nodes": 6, "jobs": 4, "count": 2, "latency_s": 0.2}


def card_solve_config(device: str,
                      small_batch_threshold: int = 0) -> SchedulerConfig:
    """The harnesses' scheduler config on the card: every batch of at
    least `small_batch_threshold` placements solved by the kernels, and
    no host microsolve. 0 (the soak and the scenarios) sends every batch
    to the card, as in every earlier server phase. The fleet keeps 8: a
    batch on the card rebuilds its 10,000-node table in Python (~0.1-0.2
    s of the one interpreter its 2,000 heartbeats a second share), so a
    batch of one to three of its 2-alloc jobs takes the host route and
    larger batches the card."""
    return SchedulerConfig(device=device,
                           small_batch_threshold=small_batch_threshold,
                           micro_solve_threshold=0)


def counter_snapshot() -> dict:
    from nomad_tpu_torch import metrics

    snap = metrics.registry().snapshot()
    dev = snap["samples"].get("nomad.tpu.device_seconds") or {}
    return dict(snap["counters"], **{
        "device_seconds": float(dev.get("sum") or 0.0),
        "device_waits": int(dev.get("count") or 0)})


def counter_delta(after: dict, before: dict, name: str) -> float:
    return after.get(name, 0) - before.get(name, 0)


def harness_run(name: str, fn, device: str = "cuda") -> tuple:
    """Run one harness with the launch counters zeroed just before and
    read just after, and its first K1-K3 calls recorded: (report,
    launches, recorders, counters before, counters after, wall)."""
    rec = server_recorders()
    before = counter_snapshot()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        # the earlier phases' heap out of the collector's passes: a pass
        # over it stops every in-process server's and client's heartbeat
        # for seconds (FrozenHeap), and a 10 s TTL does not ride it out
        with FrozenHeap():
            report = fn()
    finally:
        launches = launch_counts()
        for r in reversed(list(rec.values())):
            r.restore()
    wall = time.perf_counter() - t0
    check(all(t.device.type == device for r in rec.values()
              for t in r.tensors),
          f"a tensor of the {name} path is off {device}")
    return report, launches, rec, before, counter_snapshot(), wall


def fleet_scenario(device: str, cfg: dict) -> dict:
    """run_fleet_scale at cfg on `device` with the GPU batch worker, and
    c2m's job shape (cfg["c2m_job"] allocs, its ask, constraint and
    datacenter spread) registered through the fleet's front door once
    the registration storm is in: solved on the card at the fleet's
    width, its lost allocs re-placed through the storms beside the
    harness's own 2-alloc traffic. The job's live allocs at the end land
    in the report as "c2m_job_live"."""
    import shutil
    import tempfile

    from nomad_tpu_torch.testing import fleet as fleet_mod

    real_populate = fleet_mod.SimFleet.populate
    job = make_job("fleet-c2m", cfg["c2m_job"], dcs=["dc1"])
    stores = []

    def populate(fleet, deadline_s: float = 120.0) -> bool:
        ok = real_populate(fleet, deadline_s)
        if ok:
            stores.extend(cs.server.state
                          for cs in fleet.cluster.servers.values())
            fleet._rpc("Job.register", {"job": job})
        return ok

    root = tempfile.mkdtemp(prefix="fleet-")
    fleet_mod.SimFleet.populate = populate
    try:
        report = fleet_mod.run_fleet_scale(
            root, seed=cfg["seed"], n_servers=cfg["servers"],
            n_nodes=cfg["nodes"], steady_s=cfg["steady_s"],
            heartbeat_ttl_s=cfg["ttl_s"], driver_threads=cfg["drivers"],
            real_watchers=cfg["watchers"],
            partition_fraction=cfg["fraction"],
            register_deadline_s=max(60.0, cfg["nodes"] / 50.0),
            rate=cfg["rate"], p99_bound_s=cfg["p99_s"],
            cpu_per_node_bound=cfg["cpu_per_node"], use_tpu_worker=True,
            scheduler_config=card_solve_config(
                device, cfg["small_batch_threshold"]))
        report["c2m_job_live"] = max(
            (len([a for a in st.allocs_by_job(job.namespace, job.id)
                  if not a.terminal_status()]) for st in stores),
            default=0)
        return report
    finally:
        fleet_mod.SimFleet.populate = real_populate
        shutil.rmtree(root, ignore_errors=True)


FLEET_GATES = ("registered_all", "expiry_detected", "expiry_batched",
               "reconnect_recovered", "reconnect_batched", "converged",
               "invariants_ok")


def fleet_phase(device: str, cfg: dict) -> dict:
    """The fleet phase: its gates, the storms' raft entries and batch
    sizes, and the card's share of the phase's wall."""
    res, launches, rec, c0, c1, wall = harness_run(
        "fleet", lambda: fleet_scenario(device, cfg), device)
    for gate in FLEET_GATES:
        check(res[gate], f"fleet: {gate} failed: "
              + json.dumps({k: v for k, v in res.items()
                            if k != "loadgen"}, default=str)[:3000])
    check(res["c2m_job_live"] == cfg["c2m_job"],
          f"fleet: c2m's job has {res['c2m_job_live']} live allocs, "
          f"want {cfg['c2m_job']}")
    lg = res["loadgen"]
    return {
        "launches": launches, "rec": rec,
        "numbers": {
            "nodes": res["n_nodes"], "populate_s": res["populate_s"],
            "c2m_job_live": res["c2m_job_live"],
            "register_throttled": res["register_throttled"],
            "victims": res["victims"],
            "expiry_detect_s": res["expiry_detect_s"],
            "expire_batches": res["expire_batches"],
            "avg_expiry_batch": res["avg_expiry_batch"],
            "reconnect_s": res["reconnect_s"],
            "reconnect_batches": res["reconnect_batches"],
            "avg_reconnect_batch": res["avg_reconnect_batch"],
            "hb_p99_s": res["hb_p99_s"], "p99_bounded": res["p99_bounded"],
            "per_node_cpu_fraction":
                res["server_cpu"]["per_node_cpu_fraction"],
            "cpu_bounded": res["cpu_bounded"],
            "admission_engaged": res["admission_engaged"],
            "watch_hub_nodes_tracked_peak":
                res["watch_hub_nodes_tracked_peak"],
            "fleet": res["fleet"],
            "jobs_accepted": lg.get("accepted"),
            "evals_completed": lg.get("evals_completed"),
            "device_wait_s": counter_delta(c1, c0, "device_seconds"),
            "device_waits": counter_delta(c1, c0, "device_waits"),
            "wall_s": wall,
        },
    }


def soak_scenario(device: str, cfg: dict) -> dict:
    import shutil
    import tempfile

    from nomad_tpu_torch.testing.loadgen import run_soak

    root = tempfile.mkdtemp(prefix="soak-")
    try:
        return run_soak(
            root, duration_s=cfg["duration_s"], rate=cfg["rate"],
            seed=cfg["seed"], admission_depth=cfg["depth"],
            namespace_cap=max(8, cfg["depth"] // 2),
            blocked_cap=cfg["depth"], rpc_rate=cfg["rpc_rate"],
            rpc_burst=cfg["rpc_burst"], use_tpu_worker=True,
            partition_cycle=True, p99_bound_s=cfg["p99_s"],
            scheduler_config=card_solve_config(device))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def soak_phase(device: str, cfg: dict) -> dict:
    """The soak phase: its invariants, K1 on the card, and every device
    failover of the batch worker backed by an injected device fault."""
    res, launches, rec, c0, c1, wall = harness_run(
        "soak", lambda: soak_scenario(device, cfg), device)
    check(res["invariants_ok"], f"soak: invariants: "
          f"{res['invariant_error'][:3000]}")
    check(res["converged"], "soak: the cluster did not converge")
    failovers = int(counter_delta(c1, c0, "nomad.worker.device_failover"))
    injected = int(res["fired_faults"].get("device.fail", 0))
    check(failovers <= injected,
          f"soak: {failovers} device failovers, {injected} injected device "
          "faults: a failover with no fault behind it")
    c = res["counters"]
    return {
        "launches": launches, "rec": rec,
        "numbers": {
            "offered": res["offered"], "accepted": res["accepted"],
            "evals_completed": res["evals_completed"],
            "drained": res["drained"], "e2e_seconds": res.get("e2e_seconds"),
            "p99_bounded": res["p99_bounded"],
            "admission_engaged": res["admission_engaged"],
            "shed": c["nomad.broker.shed"],
            "rejected": c["nomad.broker.rejected"],
            "throttled_rpc": c["nomad.rpc.throttled"],
            "fired_faults": res["fired_faults"],
            "device_failovers": failovers,
            "injected_device_faults": injected,
            "per_node_cpu_fraction":
                res["server_cpu"]["per_node_cpu_fraction"],
            "device_wait_s": counter_delta(c1, c0, "device_seconds"),
            "wall_s": wall,
        },
    }


class MemberLaunches(Recorder):
    """A K1 Recorder that also counts each call by the pool member whose
    solve made it (the leader's own batch worker under "leader")."""

    def __init__(self, mod, name: str) -> None:
        super().__init__(mod, name)
        self.by_member: dict = {}

    def __call__(self, *args, **kwargs):
        member = getattr(_POOL_MEMBER, "id", None) or "leader"
        self.by_member[member] = self.by_member.get(member, 0) + 1
        return super().__call__(*args, **kwargs)


def tag_remote_solves():
    """Tag every RemoteSolver solve and warm with its member's id on
    the calling thread; returns the undo."""
    from nomad_tpu_torch.scheduler.gpu.remote_solve import RemoteSolver

    real = {name: getattr(RemoteSolver, name) for name in ("solve", "warm")}

    def tagged(fn):
        def call(self, *args, **kwargs):
            _POOL_MEMBER.id = self.node_id
            try:
                return fn(self, *args, **kwargs)
            finally:
                _POOL_MEMBER.id = None
        return call

    for name, fn in real.items():
        setattr(RemoteSolver, name, tagged(fn))
    return lambda: [setattr(RemoteSolver, n, f) for n, f in real.items()]


def check_churn(r: dict) -> None:
    """tests/test_torch_scenarios.py assert_churn_ok."""
    why = json.dumps({k: v for k, v in r.items() if k != "loadgen"},
                     default=str)[:3000]
    check(r["invariants_ok"], f"churn: invariants: {r['invariant_error']}")
    check(r["converged"], f"churn: not converged: {why}")
    check(r["stranded_nodes"] == [], f"churn: allocs stranded: {why}")
    check(r["blocked_bounded"], f"churn: blocked set unbounded: {why}")
    check(r["hard_kills"] > 0 and r["graceful_drains"] > 0,
          f"churn: both death modes must fire: {why}")
    check(r["joins"] > 0, f"churn: no joins: {why}")
    check(len(r["down_detect_latency_s"]) == r["hard_kills"],
          f"churn: a hard death went undetected: {why}")
    check(r["loadgen"]["accepted"] > 0, "churn: nothing accepted")


def check_pool_death(r: dict) -> None:
    """tests/test_torch_scenarios.py assert_pool_death_ok."""
    why = json.dumps({k: v for k, v in r.items() if k != "loadgen"},
                     default=str)[:3000]
    check(r["invariants_ok"], f"pool death: invariants: "
          f"{r['invariant_error']}")
    check(r["converged"], f"pool death: not converged: {why}")
    check(r["member_faults"] > 0, f"pool death: no member fault: {why}")
    check(r["zero_warmup_failover"],
          f"pool death: a survivor cold-started: {why}")
    check(r["post_failover_completed"] > 0,
          f"pool death: no remote solve after the failover: {why}")
    check(r["pool_counters"]["nomad.solver.pool.dispatched"] > 0,
          f"pool death: nothing dispatched: {why}")
    check(r["loadgen"]["accepted"] > 0, "pool death: nothing accepted")


def scenarios_phase(device: str, cfg: dict, on_step) -> dict:
    """The spot churn with the GPU batch worker, then the pool drill on
    ClusterServer replicas, each with tests/test_torch_scenarios.py's
    gates; K1's launches counted over both, and by pool member."""
    import shutil
    import tempfile

    from nomad_tpu_torch.testing import scenarios

    root = tempfile.mkdtemp(prefix="scenarios-")
    k1 = {}

    def run():
        t0 = time.perf_counter()
        churn = scenarios.run_spot_churn(
            root + "/churn", seed=cfg["churn_seed"],
            cycles=cfg["churn_cycles"], use_tpu_worker=True,
            scheduler_config=card_solve_config(device))
        check_churn(churn)
        on_step("scenarios.spot_churn", time.perf_counter() - t0,
                hard_kills=churn["hard_kills"],
                graceful_drains=churn["graceful_drains"],
                joins=churn["joins"],
                down_detect_latency_s=churn["down_detect_latency_s"],
                accepted=churn["loadgen"]["accepted"],
                k1_launches=tk.solve_placement_compact.launches)
        t0 = time.perf_counter()
        k1["rec"] = MemberLaunches(solver_mod, "solve_placement_compact")
        undo = tag_remote_solves()
        try:
            pool = scenarios.run_pool_member_death(
                root + "/pool", seed=cfg["pool_seed"],
                scheduler_config=card_solve_config(device))
        finally:
            undo()
            k1["rec"].restore()
        check_pool_death(pool)
        on_step("scenarios.pool_member_death", time.perf_counter() - t0,
                killed_mid_solve=pool["killed_mid_solve"],
                member_faults=pool["member_faults"],
                warmup_deltas=pool["warmup_deltas"],
                post_failover_completed=pool["post_failover_completed"],
                pool_counters=pool["pool_counters"],
                k1_by_member=k1["rec"].by_member,
                accepted=pool["loadgen"]["accepted"])
        return {"churn": churn, "pool": pool}

    try:
        res, launches, rec, c0, c1, wall = harness_run("scenarios", run,
                                                       device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "rec": rec,
            "numbers": {"k1_by_member": k1["rec"].by_member,
                        "device_wait_s": counter_delta(
                            c1, c0, "device_seconds"),
                        "wall_s": wall}}


HARNESSES = {
    "fleet": lambda device, on_step: fleet_phase(device, FLEET),
    "soak": lambda device, on_step: soak_phase(device, SOAK),
    "scenarios": lambda device, on_step: scenarios_phase(
        device, SCENARIOS, on_step),
}

HARNESS_SCRIPT = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke
chip_smoke.harness_child(json.loads(sys.argv[1]))
"""


def harness_child(args: dict) -> None:
    """The harness phases in a fresh interpreter (harness_phases): each
    run with its counters zeroed around it and its first K1-K3 calls
    replayed against their twins on the card, one phase line each;
    the results go to args["out"] as JSON."""
    device = args["device"]

    def on_step(name, seconds, **kw):
        print(json.dumps({"phase": name, "seconds": seconds, **kw},
                         default=str), flush=True)

    if device == "cuda":
        libkernels.library()
    results = {}
    for name in args["phases"]:
        t0 = time.perf_counter()
        run = HARNESSES[name](device, on_step)
        phase(name, t0, launches=run["launches"], **run["numbers"])
        check(device != "cuda"
              or run["launches"]["solve_placement_compact"] >= 1,
              f"{name}: K1 was not launched")
        held = {}
        if device == "cuda":
            held = replay_server({k: r for k, r in run["rec"].items()
                                  if run["launches"][k] > 0},
                                 run["launches"])
            check("solve_placement_compact" in held,
                  f"no {name}-path K1 call held")
        results[name] = {"launches": run["launches"], "held": held}
        del run
    with open(args["out"], "w") as fh:
        json.dump(results, fh, default=str)


def harness_phases(device: str, phases) -> dict:
    """Run the harness phases (HARNESSES) in a process of their own: a
    10,000-node fleet's 2,000 heartbeats a second share one interpreter
    with its server, and the state and threads the earlier phases leave
    behind starve them past their TTL (two of four full runs failed the
    reconnect gate in-process). Their phase lines go to this process's
    output; returns {phase: {"launches": ..., "held": ...}}."""
    import tempfile

    fd, out = tempfile.mkstemp(suffix=".json", prefix="harness-")
    os.close(fd)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", HARNESS_SCRIPT, json.dumps(
                {"device": device, "phases": list(phases), "out": out})],
            timeout=1000, cwd=os.path.dirname(os.path.abspath(__file__)))
        check(proc.returncode == 0,
              f"harness phases {list(phases)} failed "
              f"(exit {proc.returncode})")
        with open(out) as fh:
            return json.load(fh)
    finally:
        os.unlink(out)


RACE_SCRIPT = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
from nomad_tpu_torch.testing import racecheck
racecheck.install()  # before any lock of the port or of torch exists

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.scheduler.gpu import kernels as tk
from nomad_tpu_torch.server import Server

cfg = json.loads(sys.argv[1])
sched = SchedulerConfig(device="cuda", small_batch_threshold=0,
                        inject_device_latency_s=cfg["latency_s"])
server = Server(use_tpu_batch_worker=True, scheduler_config=sched)
server.establish_leadership()
for _ in range(cfg["nodes"]):
    server.node_register(mock.node())
for i in range(cfg["jobs"]):
    job = mock.job(id=f"race-pipe-{i}")
    job.task_groups[0].count = cfg["count"]
    server.job_register(job)
# mid-batch: evals dequeued and not yet acked
deadline = time.time() + 5
while server.eval_broker.stats_snapshot()["total_unacked"] == 0 \
        and time.time() < deadline:
    time.sleep(0.005)
unacked = server.eval_broker.stats_snapshot()["total_unacked"]
server.revoke_leadership()  # stop during an in-flight batch
server.establish_leadership()  # restart + drain the remainder

def placed():
    return all(
        len([a for a in server.state.allocs_by_job("default", f"race-pipe-{i}")
             if not a.terminal_status()]) == cfg["count"]
        for i in range(cfg["jobs"]))

deadline = time.time() + 60
while time.time() < deadline and not placed():
    time.sleep(0.1)
ok = placed()
server.shutdown()
print(json.dumps({"placed": ok, "unacked_at_stop": unacked,
                  "k1_launches": tk.solve_placement_compact.launches,
                  "violations": len(racecheck.violations()),
                  "report": racecheck.report()[:4000],
                  "export": racecheck.export_json()}))
"""


def racecheck_phase(cfg: dict) -> dict:
    """The pipelined Server with the GPU batch worker on cuda:0 under the
    lock-order detector, in a process of its own (locks are tracked from
    their creation): stopped mid-batch and restarted, zero inversions,
    and its edge export fed to the port's nomad-vet NV-lock-order
    cross-check, zero findings."""
    from nomad_tpu_torch.analysis import dynamic_edges_from_json, run_vet

    proc = subprocess.run(
        [sys.executable, "-c", RACE_SCRIPT, json.dumps(cfg)],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0,
          f"racecheck: the server run failed: {proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check(out["placed"], "racecheck: pipelined placement never completed")
    check(out["k1_launches"] >= 1,
          "racecheck: K1 was not launched: the batches took the host route")
    check(out["unacked_at_stop"] > 0,
          "racecheck: the server was not stopped mid-batch")
    check(out["violations"] == 0,
          f"racecheck: lock-order inversions:\n{out['report']}")
    doc = out["export"]
    keys = [e[k] for e in doc["edges"] for k in ("from", "to")]
    check(keys and not any(k.startswith("/") for k in keys),
          "racecheck: the export holds a key outside the repo")
    t0 = time.perf_counter()
    report = run_vet(rules=["NV-lock-order"],
                     dynamic_edges=dynamic_edges_from_json(json.dumps(doc)))
    vet_s = time.perf_counter() - t0
    check(report.findings == [],
          f"racecheck: nomad-vet NV-lock-order:\n{report.render()}")
    return {"unacked_at_stop": out["unacked_at_stop"],
            "k1_launches": out["k1_launches"],
            "dynamic_edges": len(doc["edges"]),
            "outside_repo": doc["outside_repo"],
            "static_edges": report.edges,
            "advisories": len(report.advisories), "vet_s": vet_s}


def client_devices(device: str) -> dict:
    """tests/test_devices.py's external-plugin case on the card: a server
    agent (the GPU batch worker on `device`, every solve on it) whose
    co-located client runs the external TPUDevice in mock mode (4
    instances) over the plugin fabric, and a client agent without it; a
    batch job of two allocs asking 2 google/tpu each lands on the
    plugin's node with disjoint instances, and each task's env carries
    them in TPU_VISIBLE_DEVICES."""
    import shutil
    import tempfile

    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.structs.structs import RequestedDevice

    root = tempfile.mkdtemp(prefix="devices-")
    agents = []
    try:
        cfg = AgentConfig(
            server_enabled=True, client_enabled=True, device=device,
            use_tpu_batch_worker=True, data_dir=root + "/server",
            datacenter="dc1", http_port=0, rpc_port=0, dev_mode=True,
            node_name="devices-server")
        cfg.device_plugins = {"tpu": {
            "factory": "nomad_tpu_torch.devices.tpu:TPUDevice",
            "config": {"mock": 4}}}
        server = Agent(cfg)
        agents.append(server)
        server.server.server.scheduler_config.small_batch_threshold = 0
        server.start()
        cluster_wait(lambda: server.server.is_leader()
                     and server.server.server._leader,
                     "devices: no established leader", 120)
        plain = Agent(AgentConfig(
            client_enabled=True, data_dir=root + "/plain",
            datacenter="dc1", http_port=0, rpc_port=0,
            client_servers=[tuple(server.server.addr)]))
        agents.append(plain)
        plain.start()
        srv = server.server.server
        state = srv.state
        dev_node = server.client.node.id
        cluster_wait(lambda: sum(1 for n in state.nodes()
                                 if n.status == "ready") == 2,
                     "devices: two ready nodes", 60)
        # beside the card (the client's in-process nvidia plugin)
        groups = state.node_by_id(dev_node).resources.devices
        check([(g.type, len(g.instances)) for g in groups
               if g.vendor == "google"] == [("tpu", 4)],
              f"devices: the plugin's node fingerprinted {groups}")
        job = mock.batch_job(id="devices-job")
        job.datacenters = ["dc1"]
        tg = job.task_groups[0]
        tg.count = 2
        task = tg.tasks[0]
        task.driver = "rawexec"
        task.config = {"command": "/bin/sh", "args": [
            "-c", "echo $TPU_VISIBLE_DEVICES > ${NOMAD_ALLOC_DIR}/data/d"]}
        task.resources.networks = []
        task.resources.devices = [RequestedDevice(name="google/tpu",
                                                  count=2)]
        tk.reset_launch_counts()
        rec = Recorder(solver_mod, "solve_placement_compact")
        try:
            t0 = time.perf_counter()
            srv.job_register(job)
            cluster_wait(
                lambda: len(state.allocs_by_job("default", job.id)) == 2
                and all(a.client_status == "complete"
                        for a in state.allocs_by_job("default", job.id)),
                "devices: the device job did not complete", 60)
            done_s = time.perf_counter() - t0
            k1 = launch_counts()["solve_placement_compact"]
        finally:
            rec.restore()
        check(k1 >= 1, "devices: K1 was not launched: the device job "
              "took the host route")
        check(all(t.device.type == device for t in rec.tensors),
              f"devices: a tensor of the K1 call is off {device}")
        held = hold_k1(*rec.first)
        check(held["max_abs_err"] == 0, "devices: the K1 call differs")
        held.update(bound(held.pop("nbytes"), held.pop("ops", 0)))
        allocs = state.allocs_by_job("default", job.id)
        check(all(a.node_id == dev_node for a in allocs),
              "devices: an alloc landed off the plugin's node")
        ids = [tuple(d["device_ids"])
               for a in allocs
               for d in a.resources.tasks[task.name].devices]
        flat = [i for row in ids for i in row]
        check(len(ids) == 2 and len(set(flat)) == 4,
              f"devices: instances not disjoint: {ids}")
        seen = []
        for a in allocs:
            runner = server.client.alloc_runners[a.id]
            path = runner.allocdir.data_dir + "/d"
            seen.append(open(path).read().strip())
        want = sorted(",".join(i.rsplit("-", 1)[-1] for i in row)
                      for row in ids)
        check(sorted(seen) == want,
              f"devices: TPU_VISIBLE_DEVICES {seen}, want {want}")
        return {"allocs": len(allocs), "device_ids": sorted(ids),
                "task_env": sorted(seen), "done_s": done_s,
                "k1_launches": k1, "k1_held": held}
    finally:
        for a in reversed(agents):
            a.shutdown()
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

    # 1. build
    t0 = time.perf_counter()
    libkernels.library()
    phase("build", t0, nvcc_seconds=libkernels.build_seconds)
    ptxas = [ln.strip() for ln in libkernels.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(json.dumps({"ptxas": ptxas}), flush=True)

    # 2. each kernel against its twin at the c2m bucket
    t0 = time.perf_counter()
    k4_placing = kernel_checks(dev, args.seed)
    phase("kernels", t0)

    # 3. the main path at c2m, launch counters zeroed just before
    rec = {name: Recorder(solver_mod, name)
           for name in ("solve_placement_compact", "scatter_rows",
                        "scatter_add_rows")}
    t_main = time.perf_counter()
    tk.reset_launch_counts()
    trace.set_enabled(True)
    res = three_waves("cuda", 10000, 100, 1000, 20,
                      on_wave=lambda name, t, **kw: phase(f"main.{name}", t,
                                                          **kw))
    trace.set_enabled(False)
    torch.cuda.synchronize()
    launches = {name: getattr(tk, name).launches for name in rec}
    for r in rec.values():
        r.restore()
    phase("main", t_main, launches=launches, syncs=res["syncs"],
          allocs_placed=len(res["placed"]))
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    check_main(res, 100, 1000, 20)
    resident = res["resident"]
    on_card = [resident._cap_dev, resident._used_dev]
    on_card += [c[1] for c in res["chains"]]
    for r in rec.values():
        on_card += r.tensors
    check(all(t.is_cuda for t in on_card), "a tensor of the path is on the host")

    # 4. the preemption route at c2m, launch counters zeroed just before
    #    the wave
    prec = {name: Recorder(solver_mod, name)
            for name in ("solve_placement", "solve_placement_preempt")}
    t_pre = time.perf_counter()
    trace.set_enabled(True)
    pres = preempt_scenario(
        "cuda", 10000, C2M_FILLS, (20, 1000, True),
        before_wave=tk.reset_launch_counts,
        on_wave=lambda name, t, **kw: phase(name, t, **kw),
    )
    trace.set_enabled(False)
    torch.cuda.synchronize()
    pre_launches = {name: getattr(tk, name).launches for name in prec}
    for r in prec.values():
        r.restore()
    phase("preempt", t_pre, launches=pre_launches,
          placed=len(pres["placed"]), evicted=len(pres["victims"]),
          unplaced=pres["unplaced"], victim_prios=pres["victim_prios"])
    for name, n in pre_launches.items():
        check(n > 0, f"kernel {name} was not launched on the preempt path")
    check_preempt(pres, 20 * 1000, {65: 25 * 900})
    on_card = []
    for r in prec.values():
        on_card += r.tensors
    check(all(t.is_cuda for t in on_card),
          "a tensor of the preempt path is on the host")
    del pres
    launches.update(pre_launches)

    # 5. the per-eval schedulers under node-drain churn (BASELINE config
    #    5 with an overlapping rollout) at c2m's width, launch counters
    #    zeroed just before
    drain_rec = Recorder(solver_mod, "scatter_rows",
                         keep=lambda args: args[3] is False)
    t_drain = time.perf_counter()
    trace.set_enabled(True)
    tk.reset_launch_counts()
    t_stage = [time.perf_counter()]

    def on_stage(name):
        phase(f"drain.{name}", t_stage[0])
        t_stage[0] = time.perf_counter()

    dres = drain_scenario("cuda", 10000, DRAIN_SVC_JOBS, DRAIN_SVC_COUNT,
                          DRAIN_NODES, seed=args.seed, on_stage=on_stage)
    trace.set_enabled(False)
    torch.cuda.synchronize()
    drain_launches = {
        "solve_placement_compact": tk.solve_placement_compact.launches,
        "scatter_rows": tk.scatter_rows.launches,
        "scatter_rows_copy": tk.scatter_rows.launches_copy,
    }
    drain_rec.restore()
    phase("drain", t_drain, workload=DRAIN_WORKLOAD, launches=drain_launches,
          evals={k: len(v) for k, v in dres["stages"].items()},
          stages_ms=stage_summary(dres["stages"]), routes=dres["routes"],
          live_allocs=len(dres["placed_pos"]))
    check(drain_launches["solve_placement_compact"] >= 40,
          f"K1 ran {drain_launches['solve_placement_compact']} times in "
          "the drain phase, want >= 40")
    check(drain_launches["scatter_rows_copy"] >= 1,
          "K2's non-donated mode was not launched in the drain phase")
    check(drain_rec.first is not None, "no non-donated K2 call recorded")
    check_drain(dres, DRAIN_SVC_JOBS, DRAIN_SVC_COUNT)
    check(all(t.is_cuda for t in drain_rec.tensors),
          "a tensor of the drain path is on the host")
    launches["scatter_rows_copy"] = drain_launches["scatter_rows_copy"]
    del dres

    # 6. the server's scheduling pipeline at c2m's width: c2m's 100 jobs
    #    through Server.job_register, then the roll wave, launch counters
    #    zeroed just before the first register and read after the roll;
    #    then one injected device failover, a system job placed on a
    #    new node, and the first SERVER_OVERLAP_JOBS jobs serial and
    #    pipelined
    from nomad_tpu_torch import native

    def on_server(name, seconds, **kw):
        print(json.dumps({"phase": name, "seconds": seconds, **kw}),
              flush=True)

    t_srv = time.perf_counter()
    srec = server_recorders()
    trace.set_enabled(True)
    try:
        sres = server_scenario("cuda", 10000, 100, 1000, on_server)
    finally:
        trace.set_enabled(False)
        for r in reversed(list(srec.values())):
            r.restore()
    server_launches = sres["launches"]
    check(all(t.is_cuda for r in srec.values() for t in r.tensors),
          "a tensor of the server path is on the host")
    numbers = dict(sres["numbers"],
                   fastpack_build_s=native.last_build_seconds)
    phase("server", t_srv, launches=server_launches, **numbers)
    check_server(sres)
    srv = sres["srv"]
    try:
        t0 = time.perf_counter()
        fo = server_failover(srv, sres["live"])
        phase("server.failover", t0, **fo)
        t0 = time.perf_counter()
        sy = server_system(srv, sres["live"] + 4 * 50)
        phase("server.system", t0, **sy)
    finally:
        srv.shutdown()
    del sres, srv
    t0 = time.perf_counter()
    phase("server.overlap", t0, **server_overlap(
        "cuda", 10000, SERVER_OVERLAP_JOBS, 1000))

    # 7. the solver pool: c2m's jobs and the roll wave through the leader's
    #    Server, every batch solved by one of two warm members over real
    #    sockets, launch counters zeroed just before the first register
    #    and read after the roll; then a member fault, the leader's card
    #    against a member in lockstep, and the pool's scaling
    t_pool = time.perf_counter()
    pool_rec = pool_recorders()
    trace.set_enabled(True)
    try:
        pool_res = pool_c2m("cuda", 10000, POOL_C2M_JOBS, 1000, on_server)
    finally:
        trace.set_enabled(False)
        for r in reversed(list(pool_rec.values())):
            r.restore()
    pool_launches = pool_res["launches"]
    try:
        check(all(t.is_cuda for r in pool_rec.values() for t in r.tensors),
              "a tensor of the pool path is on the host")
        check_pool(pool_res, "cuda")
        pool_held = replay_pool(pool_rec, len(pool_res["pc"]["members"]))
        phase("pool.c2m", t_pool, launches=pool_launches,
              caveat=POOL_CAVEAT, **pool_res["numbers"])
        t0 = time.perf_counter()
        phase("pool.failover", t0,
              **pool_failover(pool_res["pc"], pool_res["live"]))
    finally:
        pool_shutdown(pool_res["pc"])
    del pool_res, pool_rec
    t0 = time.perf_counter()
    lock = pool_lockstep("cuda", 10000, 100, 1000, 4)
    check(lock["member"] == lock["local"],
          "pool lockstep: the member's plans differ from the leader's")
    check(all(len(b) > 0 for b in lock["local"]),
          "pool lockstep: a batch placed nothing")
    phase("pool.lockstep", t0, batches=len(lock["local"]),
          allocs_compared=sum(len(b) for b in lock["local"]))
    t0 = time.perf_counter()
    phase("pool.scaling", t0, **pool_scaling("cuda"))
    phase("pool", t_pool, launches=pool_launches)

    # 7b. the wire codec: one pool reply of 8 of c2m's jobs solved on the
    #    card (launch counters zeroed just before the solve and read
    #    just after) through the C fastpack and the Python twins
    t0 = time.perf_counter()
    codec_res = codec_phase("cuda")
    codec_launches = codec_res["launches"]
    phase("codec", t0, launches=codec_launches, **codec_res["numbers"])

    # 8. the job lifecycle at c2m's width through the Server's endpoints:
    #    two plans, four canary rollouts promoted and rolled, an
    #    auto-revert, a 10% drain, a periodic and a dispatched child;
    #    launch counters zeroed just before the first plan and read after
    #    the children are placed
    t_life = time.perf_counter()
    lrec = lifecycle_recorders()
    trace.set_enabled(True)
    try:
        lres = lifecycle_scenario("cuda", 10000, args.seed, on_server)
    finally:
        trace.set_enabled(False)
        for r in reversed(list(lrec.values())):
            r.restore()
    life_launches = lres["launches"]
    try:
        check(all(t.is_cuda for r in lrec.values() for t in r.tensors),
              "a tensor of the lifecycle path is on the host")
        check_lifecycle_run(lres)
        check(lrec["scatter_rows_copy"].first is not None,
              "no lifecycle non-donated K2 call recorded")
        used_c, idx_c = lrec["scatter_rows_copy"].first[0][:2]
        phase("lifecycle", t_life, launches=life_launches,
              health=LIFE_HEALTH, compact_batches=lres["compact_batches"],
              chained_batches=lres["chained_batches"],
              partial_commits=lres["partial_commits"],
              watcher=lres["watcher"],
              k2_copy_first={"np": used_c.shape[0], "rows": idx_c.shape[0],
                             "kept": int(((idx_c >= 0)
                                          & (idx_c < used_c.shape[0]))
                                         .sum())})
    finally:
        lres["srv"].shutdown()
    del lres

    # 9. the tenancy and cluster tables at c2m's width through the
    #    Server's endpoints: the fleet through the node-register batcher,
    #    namespaces and the C1 refusal, ACL, CSI volumes with their
    #    claims and the volume watcher, scaling policies, services with
    #    the watch hub, secrets and Vault task tokens, the event stream
    #    held across; launch counters zeroed just before the first
    #    registration and read after the last step
    t_ten = time.perf_counter()
    armed = {"on": False}
    trec = tenancy_recorders(armed)
    trace.set_enabled(True)
    try:
        tres = tenancy_scenario("cuda", TEN, on_server, armed)
    finally:
        trace.set_enabled(False)
        for r in trec.values():
            r.restore()
    ten_launches = tres["launches"]
    try:
        check(all(t.is_cuda for r in trec.values() for t in r.tensors),
              "a tensor of the tenancy path is on the host")
        check_tenancy_run(tres)
        k1_first = trec["solve_placement_compact"].first
        check(k1_first is not None, "no masked K1 call recorded")
        masked = masked_nodes(k1_first[0])
        plugin_nodes = tres["steps"]["volumes"]["plugin_nodes"]
        check(masked == plugin_nodes,
              f"the data jobs' K1 call may place on {masked} nodes, "
              f"want the plugin's {plugin_nodes}")
        phase("tenancy", t_ten, launches=ten_launches, events=tres["events"],
              live_allocs=tres["live"], masked_k1_nodes=masked,
              volume_watcher=tres["volume_watcher"])
    finally:
        tres["srv"].shutdown()
    del tres

    # 10. replication and the cluster at c2m's width: three
    #    ClusterServers, the fleet through the followers, c2m's first 25
    #    jobs, a leader kill, the next 25 on the new leader, a restart
    #    from disk; launch counters zeroed just before the first job
    #    register and read after the failover's last placement
    t_cl = time.perf_counter()
    crec = server_recorders()
    trace.set_enabled(True)
    try:
        with FrozenHeap():
            cres = cluster_scenario("cuda", CLUSTER, on_server)
    finally:
        trace.set_enabled(False)
        for r in reversed(list(crec.values())):
            r.restore()
    cluster_launches = cres["launches"]
    check(all(t.is_cuda for r in crec.values() for t in r.tensors),
          "a tensor of the cluster path is on the host")
    check_cluster_run(cres)
    phase("cluster", t_cl, launches=cluster_launches,
          log_entries=cres["log_entries"], snapshot=cres["snapshot"],
          shutdown_s=cres["shutdown_s"])
    # the AppendEntries requests of each step, msgpack frames with the
    # packed entries as bins
    ae = {name: st["append_entries"] for name, st in cres["steps"].items()}
    print(json.dumps({
        "phase": "cluster.append_entries", "by_step": ae,
        "calls": sum(a["calls"] for a in ae.values()),
        "sent_bytes": sum(a["sent_bytes"] for a in ae.values()),
        "fastpack_live": cres["fastpack_live"]}), flush=True)
    del cres

    # 11. the operator's front door at c2m's width: one server agent,
    #    c2m's fleet over its fabric, c2m's 100 jobs as HCL through the
    #    CLI's job plan and job run, an operator's reads over HTTP;
    #    launch counters zeroed just before the job plan and read after
    #    the last eval completes
    t_ag = time.perf_counter()
    arec = server_recorders()
    trace.set_enabled(True)
    try:
        ares = agent_scenario("cuda", AGENT, on_server)
    finally:
        trace.set_enabled(False)
        for r in reversed(list(arec.values())):
            r.restore()
    agent_launches = ares["launches"]
    check(all(t.is_cuda for r in arec.values() for t in r.tensors),
          "a tensor of the agent path is on the host")
    check_agent_run(ares)
    phase("agent", t_ag, launches=agent_launches,
          shutdown_s=ares["shutdown_s"])
    del ares

    # 12. the client: a server agent with a co-located client and three
    #    client agents joined over the fabric, c2m's fleet beside their
    #    four real nodes, c2m's job at C2M's density on the real nodes
    #    through the CLI, process tasks given the card, a drain, a
    #    client agent's restart with its tasks left running, a stop;
    #    launch counters zeroed just before the first job run and read
    #    after the stop settles
    t_cl = time.perf_counter()
    clrec = client_recorders()
    trace.set_enabled(True)
    try:
        clres = client_scenario("cuda", CLIENT, on_server)
    finally:
        trace.set_enabled(False)
        for r in reversed(list(clrec.values())):
            r.restore()
    client_launches = clres["launches"]
    check(all(t.is_cuda for r in clrec.values() for t in r.tensors),
          "a tensor of the client path is on the host")
    check_client_run(clres)
    k1_shapes = sorted(set(clrec["solve_placement_compact"].shapes))
    phase("client", t_cl, launches=client_launches, syncs=clres["syncs"],
          k1_shapes=[dict(zip(("np", "gp", "live_groups", "max_count"), s))
                     for s in k1_shapes],
          peak_threads=clres["peak_threads"],
          peak_rss_mb=clres["peak_rss_mb"], shutdown_s=clres["shutdown_s"])
    client_outcome = clres["restart_outcome"]
    del clres
    t0 = time.perf_counter()
    phase("client.devices", t0, **client_devices("cuda"))

    # 13-15. the fleet (run_fleet_scale at bench.py's fleet settings and
    #    c2m's 10,000 simulated nodes), the soak (run_soak at bench.py's
    #    soak settings, under the fault schedule) and the scenarios (spot
    #    churn; the solver pool's member death and warm failover on
    #    ClusterServer replicas), the GPU batch worker on cuda:0, in a
    #    process of their own; each with the launch counters zeroed just
    #    before the harness and read after, its first K1-K3 calls
    #    replayed against their twins there
    t0 = time.perf_counter()
    threads_before = threading.active_count()
    harness = harness_phases("cuda", ("fleet", "soak", "scenarios"))
    phase("harness", t0, threads_in_this_process=threads_before)

    # 16. the lock-order detector over the pipelined server on cuda:0, in
    #    a process of its own, and nomad-vet's cross-check of its edges
    t0 = time.perf_counter()
    phase("racecheck", t0, **racecheck_phase(RACE))

    # 17. the mesh route: c2m_sharded at full width, then the preempt wave
    #    on 8 shards, each with the launch counters zeroed around it
    t_mesh = time.perf_counter()
    trace.set_enabled(True)
    mesh_paths = {
        "sharded_solver": c2m_sharded(phase),
        "sharded_solver_preempt": preempt_on_mesh(phase),
    }
    trace.set_enabled(False)
    for name, res in mesh_paths.items():
        launches[name] = res["launches"]
    phase("mesh", t_mesh, launches={n: launches[n] for n in mesh_paths})

    # 18. replay each path's calls against the twins, and time them
    t0 = time.perf_counter()
    kernels = replay(rec, launches, drain_rec, dev, args.seed)
    kernels[1:1] = replay_dense(prec, launches, k4_placing)
    kernels += replay_mesh(mesh_paths, launches)
    server_held = replay_server(srec, server_launches)
    for k in kernels:
        k["server_launches"] = server_launches[k["name"]]
        if k["name"] in server_held:
            k["server"] = server_held[k["name"]]
    if "scatter_rows_copy" in server_held:
        kernels[[k["name"] for k in kernels].index("scatter_rows")][
            "server_copy"] = server_held["scatter_rows_copy"]
    for k in kernels:
        k["pool_launches"] = pool_launches[k["name"]]
        if k["name"] in pool_held:
            k["pool"] = pool_held[k["name"]]
    kernels[[k["name"] for k in kernels].index("scatter_rows")][
        "pool_copy"] = pool_held["scatter_rows_copy"]
    life_held = replay_server(lrec, life_launches)
    for k in kernels:
        k["lifecycle_launches"] = life_launches[k["name"]]
    names = [k["name"] for k in kernels]
    kernels[names.index("solve_placement_compact")]["lifecycle"] = \
        life_held["solve_placement_compact"]
    kernels[names.index("scatter_rows")]["lifecycle_copy"] = \
        life_held["scatter_rows_copy"]
    kernels[names.index("scatter_rows")]["lifecycle_launches_copy"] = \
        life_launches["scatter_rows_copy"]
    ten_held = replay_server(trec, ten_launches)
    ten_held["solve_placement_compact"]["masked_nodes"] = masked
    for k in kernels:
        k["tenancy_launches"] = ten_launches[k["name"]]
    kernels[names.index("solve_placement_compact")]["tenancy"] = \
        ten_held["solve_placement_compact"]
    kernels[names.index("scatter_rows")]["tenancy_launches_copy"] = \
        ten_launches["scatter_rows_copy"]
    cl_held = replay_server({k: r for k, r in crec.items()
                             if cluster_launches[k] > 0}, cluster_launches)
    for k in kernels:
        k["cluster_launches"] = cluster_launches[k["name"]]
        if k["name"] in cl_held:
            k["cluster"] = cl_held[k["name"]]
    kernels[names.index("scatter_rows")]["cluster_launches_copy"] = \
        cluster_launches["scatter_rows_copy"]
    del crec
    ag_held = replay_server({k: r for k, r in arec.items()
                             if agent_launches[k] > 0}, agent_launches)
    check("solve_placement_compact" in ag_held,
          "no agent-path K1 call held")
    for k in kernels:
        k["agent_launches"] = agent_launches[k["name"]]
        if k["name"] in ag_held:
            k["agent"] = ag_held[k["name"]]
    kernels[names.index("scatter_rows")]["agent_launches_copy"] = \
        agent_launches["scatter_rows_copy"]
    del arec
    for k in kernels:
        k["codec_launches"] = codec_launches[k["name"]]
    kernels[names.index("solve_placement_compact")]["codec"] = \
        codec_res["k1"]
    del codec_res
    cl_held = replay_server({k: r for k, r in clrec.items()
                             if client_launches[k] > 0}, client_launches)
    check("solve_placement_compact" in cl_held,
          "no client-path K1 call held")
    for k in kernels:
        k["client_launches"] = client_launches[k["name"]]
        if k["name"] in cl_held:
            k["client"] = cl_held[k["name"]]
    kernels[names.index("scatter_rows")]["client_launches_copy"] = \
        client_launches["scatter_rows_copy"]
    del clrec
    for path, run in harness.items():
        for k in kernels:
            k[f"{path}_launches"] = run["launches"][k["name"]]
            if k["name"] in run["held"]:
                k[path] = run["held"][k["name"]]
        kernels[names.index("scatter_rows")][f"{path}_launches_copy"] = \
            run["launches"]["scatter_rows_copy"]
    phase("replay", t0)

    # 19. the same waves at 200 nodes, at 500 nodes on an 8-shard mesh,
    #    bench.py's preempt config and its drain config, its pipeline
    #    config through the batch worker driven by hand, the lifecycle's
    #    five steps and the tenancy steps at 200 nodes driven by hand,
    #    the three-server cluster one eval at a time through a kill
    #    and a restart, the server agent one HCL job at a time
    #    through the CLI with its HTTP reads, and a dev agent and a
    #    client agent running tasks through a drain, a restart and a
    #    stop: card == CPU twins
    t0 = time.perf_counter()
    small_gpu = three_waves("cuda", 200, 8, 200, 2)
    small_cpu = three_waves("cpu", 200, 8, 200, 2)
    check(small_gpu["placed_pos"] == small_cpu["placed_pos"],
          "card and CPU twins placed differently")
    check(small_gpu["syncs"] == small_cpu["syncs"], "sync sequence differs")
    mesh_gpu = three_waves("cuda", 500, 8, 200, 2, mesh=8)
    mesh_cpu = three_waves("cpu", 500, 8, 200, 2, mesh=8)
    check(mesh_gpu["placed_pos"] == mesh_cpu["placed_pos"],
          "mesh: card and CPU twins placed differently")
    check(mesh_gpu["syncs"] == mesh_cpu["syncs"], "mesh sync sequence differs")
    check_main(mesh_gpu, 8, 200, 2)
    pre_gpu = preempt_scenario("cuda", 500, BENCH_FILLS, (20, 50, False))
    pre_cpu = preempt_scenario("cpu", 500, BENCH_FILLS, (20, 50, False))
    for k in ("placed", "preempted_by", "victims", "unplaced"):
        check(pre_gpu[k] == pre_cpu[k],
              f"bench preempt config: card and CPU twins differ in {k}")
    check(len(pre_gpu["victims"]) > 0, "bench preempt config evicted nothing")
    check_preempt(pre_gpu, 20 * 50, {})
    # bench.py run_drain_config: 1,000 nodes, 20 x 100 service allocs
    # (no constraint or spread), then one system job, 100 nodes drained;
    # K2's non-donated launches counted over the card's run
    tk.reset_launch_counts()
    drain_small = {"cuda": drain_scenario("cuda", 1000, 20, 100, 100,
                                          bench=True, seed=args.seed)}
    torch.cuda.synchronize()
    bench_drain_copies = tk.scatter_rows.launches_copy
    drain_small["cpu"] = drain_scenario("cpu", 1000, 20, 100, 100,
                                        bench=True, seed=args.seed)
    dg, dc = drain_small["cuda"], drain_small["cpu"]
    check(dg["placed_pos"] == dc["placed_pos"],
          "bench drain config: card and CPU twins placed differently")
    check([(e.job_id, e.status, e.queued_allocations) for e in dg["evals"]]
          == [(e.job_id, e.status, e.queued_allocations)
              for e in dc["evals"]],
          "bench drain config: card and CPU twins' evals differ")
    check(not any(pos < 100 for pos in dg["placed_pos"].values()),
          "bench drain config: a live alloc is left on a drained node")
    # bench.py run_pipeline_config: 2,000 nodes, 64 jobs x 300 allocs
    # (no constraint or spread), batches of 8, the same nodes and jobs on
    # the card and on the CPU twins
    pipe_nodes = c2m_nodes(2000)
    pipe_jobs = [make_job(f"pipe-{j}", 300, constrained=False)
                 for j in range(64)]
    lock_gpu = server_lockstep("cuda", pipe_nodes, pipe_jobs, 8)
    lock_cpu = server_lockstep("cpu", pipe_nodes, pipe_jobs, 8)
    check(lock_gpu["placed"] == lock_cpu["placed"],
          "pipeline config: card and CPU twins placed differently")
    check(len(lock_gpu["placed"]) == 64 * 300,
          f"pipeline config placed {len(lock_gpu['placed'])}, want 19200")
    check(lock_gpu["verdicts"] == lock_cpu["verdicts"],
          "pipeline config: the chain verdicts differ")
    check(any(c and a for c, a, _ in lock_gpu["verdicts"]),
          "pipeline config: no batch chained")
    # the lifecycle at LIFE_SMALL: 200 nodes, 20 jobs of 50 (canary 2,
    # max_parallel 10, migrate 5), a seeded 10% drained
    life_nodes = c2m_nodes(200)
    life_drained = random.Random(args.seed).sample(
        sorted(n.id for n in life_nodes),
        int(200 * LIFE_SMALL["drain_ratio"]))
    life_gpu = lifecycle_small("cuda", life_nodes, life_drained)
    life_cpu = lifecycle_small("cpu", life_nodes, life_drained)
    for key in life_gpu:
        check(life_gpu[key] == life_cpu[key],
              f"lifecycle: card and CPU twins differ in {key}")
    check(any(c and a for _, c, a, _ in life_gpu["verdicts"]),
          "lifecycle: no batch chained")
    # the tenancy steps at TEN_SMALL: 200 nodes, jobs of 50
    ten_nodes = with_plugin(c2m_nodes(TEN_SMALL["nodes"]), compute_node_class)
    ten_gpu = tenancy_small("cuda", ten_nodes)
    ten_cpu = tenancy_small("cpu", ten_nodes)
    for key in ten_gpu:
        check(ten_gpu[key] == ten_cpu[key],
              f"tenancy: card and CPU twins differ in {key}")
    # the cluster at CLUSTER_SMALL: 200 nodes, jobs of 50
    cl_nodes = c2m_nodes(CLUSTER_SMALL["nodes"])
    cl_gpu = cluster_small("cuda", cl_nodes)
    cl_cpu = cluster_small("cpu", cl_nodes)
    for key in cl_gpu:
        check(cl_gpu[key] == cl_cpu[key],
              f"cluster: card and CPU twins differ in {key}")
    # the server agent at AGENT_SMALL: 200 nodes, HCL jobs of 50
    ag_nodes = c2m_nodes(AGENT_SMALL["nodes"])
    ag_gpu = agent_small("cuda", ag_nodes)
    ag_cpu = agent_small("cpu", ag_nodes)
    for key in ag_gpu:
        check(ag_gpu[key] == ag_cpu[key],
              f"agent: card and CPU twins differ in {key}")
    # the client at CLIENT_SMALL: 200 nodes, two real ones, two mock jobs
    # of 20 and a raw_exec task through a drain, a restart and a stop
    cli_nodes = c2m_nodes(CLIENT_SMALL["nodes"])
    cli_gpu = client_small("cuda", cli_nodes)
    cli_cpu = client_small("cpu", cli_nodes)
    for key in cli_gpu:
        check(cli_gpu[key] == cli_cpu[key],
              f"client: card and CPU twins differ in {key}")
    check(cli_gpu["raw_kept"], "client lockstep: the raw_exec task was "
          "not reattached across the restart")
    check(client_outcome == cli_gpu["restart_outcome"],
          f"client: the restarted agent's mock allocs ended as "
          f"{client_outcome}, client_lockstep's as "
          f"{cli_gpu['restart_outcome']}")
    phase("small", t0, allocs_compared=len(small_gpu["placed"]),
          mesh_allocs_compared=len(mesh_gpu["placed"]),
          preempt_placed=len(pre_gpu["placed"]),
          preempt_evicted=len(pre_gpu["victims"]),
          drain_allocs_compared=len(dg["placed_pos"]),
          drain_evals=len(dg["evals"]),
          drain_k2_copy_launches=bench_drain_copies,
          pipeline_allocs_compared=len(lock_gpu["placed"]),
          pipeline_verdicts=lock_gpu["verdicts"],
          lifecycle_allocs_compared=len(life_gpu["placed"]),
          lifecycle_deployments=len(life_gpu["deployments"]),
          lifecycle_drain_passes=[sum(n for _, n in p)
                                  for p in life_gpu["drain_passes"]],
          lifecycle_batches=len(life_gpu["verdicts"]),
          tenancy_allocs_compared=len(ten_gpu["placed"]),
          tenancy_claims_compared=sum(len(c) for c in
                                      ten_gpu["claims"].values()),
          tenancy_events_compared=sum(len(b) for _, b in ten_gpu["events"]),
          tenancy_batches=len(ten_gpu["verdicts"]),
          cluster_allocs_compared=cl_gpu["allocs_compared"],
          cluster_placements=sum(n for _, n in cl_gpu["placed"]),
          cluster_evals=len(cl_gpu["evals"]),
          agent_allocs_compared=len(ag_gpu["allocs"]),
          agent_reads_compared=len(ag_gpu["reads"]),
          client_allocs_compared=len(cli_gpu["steps"]["stop"]),
          client_reads_compared=len(cli_gpu["reads"]),
          client_restart_outcome=cli_gpu["restart_outcome"])

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
