"""Drive the PyTorch/CUDA port of the scheduler on one NVIDIA GPU and check
it: the batched assignment solve and its kernel, the core scheduling cycle
around them, both again on a batch with pod locality and on a labelled
fleet with topology steering, the device preemption planner, the device
admission gate with the device-resident node, victim and request state,
the pack and cvx duel arms of solver.policy=optimal, the learned policy's
serving path (solver.policy=learned and all) and its trainer, the shim,
mock scheduler and scheduler binary that bring a cluster's pods to the
core, the real-cluster client (--kubeconfig), the admission webhook in
front of it, the trace-replay driver, the sharded control plane
(solver.shards >= 2), and node-dim sharding over a device mesh
(solver.shard).

    python3 chip_smoke.py
    python3 chip_smoke.py --only admit --repeat 8   # one phase, 8 runs

Phases, each printing one JSON line (the script exits non-zero when any
phase fails, and when no CUDA device is present):

  build   compile every CUDA kernel of the path from yunikorn_tpu_torch/csrc
          (one nvcc process per source, started together)
  warm    the warm-start layer on one kernel-library store it builds:
          `python -m yunikorn_tpu_torch.cmd.aot_smoke`'s three fresh
          children at WARM_BUCKET (1,024 nodes x 10,240 pods): the cold
          child on the empty store builds every kernel with nvcc and stores
          it, the hit and prewarm children count a store hit per kernel and
          build nothing (aot.compile_count() 0), all three place
          identically, the prewarm child's first cycle is within
          WARM_MAX_RATIO of the median of its warm cycles of new pods (the
          ratio against warm cycles that re-submit the first cycle's asks,
          the JAX smoke's trace, is reported beside it), and every best_nodes
          (and learned_propose) call the prewarm makes equals its plain
          version; each child's first-cycle cold_split (nvcc build and load
          ms, device allocations, reserved-bytes growth, stage ms) and warm
          ms; then the binary at the kube phase's shape (CMD_NODES nodes,
          one wave of KUBE_WAVE pods, no watch kill) with --aot-store and
          --prewarm WARM_KUBE_BUCKET: every pod bound once, a store hit per
          kernel and no build, its first cycle and cold_split and the first
          bind after the first pod; then replay C's fresh-process takeover
          with --aot-store on the store and the bucket prewarm: the child
          counts a hit per kernel and builds nothing, its cold verdict ok,
          every bound pod restored
  kernel  each kernel against its plain PyTorch version on the card at the
          main path's shapes, both modes and soft variants, plus
          all-infeasible, forced-tie and ragged-M cases, masks of requested
          rows (30%, none, 129 rows), ties that straddle the kernel's
          node-slice boundaries, and R = 12 (the wide variant); and the
          planned-domain bonus of topology steering at its path's shapes
          (random, ties made only by its + 8.0 rounding, a row mask, no
          row steered, slice-straddling ties inside one domain, R = 12):
          bit-equal
  cut     the whole solve at 2,000 nodes x 10,000 pods of the slice's mixed
          workload, on `cuda` (kernel) and on `cpu` (plain): bit-identical
          assigned / accept_round / free_after / rounds
  main    the main path at full width: 10,000 nodes x 50,000 pods through
          the port's encoder and solve_batch on `cuda`, with the kernel
          launch counts read around that one run; 16 rounds and 45,977 pods
          placed (the JAX package's result on the same workload), no node
          oversubscribed, every placement feasible; timings; for each odd
          round the rows it requested and the kernel's CUDA-event ms at that
          round's inputs, their sum over the solve, the full-function ms
          (every row) at the first odd round's inputs, and the bound and its
          share for each (the bound from the card's clocks.max.sm); a
          device profile of one solve, and one of the solve's best_nodes
          calls (each call runs a memset and three kernels: prep, main,
          finish); then the same solve on the encoder's device-resident
          state (mirror): the row store's req equal to batch.req and a 1%
          churn uploading only the churned rows, the solve on the mirror
          equal to the host-array solve, a full first refresh and a clean
          warm one (0 bytes), warm ms, and the HtoD ms of a profiled solve
          on the host arrays, on a clean mirror and right after
          discard_device_mirror
  core    the port's CoreScheduler on `cuda`, the scheduling cycle users
          call (quota gate, rank, encode, solve, commit), in three parts:
          bench.py's core-cycle shape (10,000 kwok nodes x 50,000 sleep pods
          in 5 queues: a 512-pod warm-up cycle, a release, a cold 50,000-pod
          cycle, a release, a warm one; all 50,000 placed in each, every
          solve on the ladder's device tier, pods/s, the cold first cycle,
          the warm cycle's stage split and its kernel launches, a profiled
          warm cycle on a clean mirror (0 node bytes) and one right after
          discard_device_mirror (a full upload) with their HtoD ms, a 1%
          churn cycle whose row store uploads only the churned rows, the
          core's cold_split (its first cycle, the warm-up), and one
          --prewarm bucket at this shape whose peak device allocation and
          the warm cycle's fit the card together); the
          pressure mix through the core (10,000 x 50,000, one cycle:
          best_nodes launched, no node oversubscribed, every binding
          satisfying its pod's selector and taints, placements equal to a
          direct solve_batch on the batch the core encoded); and at the cut
          (2,000 x 10,000, the pressure mix) one cycle on `cuda` and one on
          `cpu` binding identically by pod name, with the JAX package's
          core's placed count
  locality the locality mix (client/synthetic.make_locality_pods: the
          pressure mix's five apps, zone-spread replicas, one-per-node
          anti-affinity replicas and ScheduleAnyway zone-spread pods) on the
          pressure fleet. At the cut (2,000 x 10,000) solve_batch on `cuda`
          and on `cpu` bit-identical (assigned / accept_round / free_after /
          rounds / cnt_final) and one core cycle on each binding identically
          by pod name; at full width (10,000 x 50,000) through solve_batch
          on `cuda`, the kernel's launches read around that one run: the JAX
          package's rounds and placed count, no node oversubscribed, every
          placement inside its group's static feasibility, no two
          anti-affinity pods on one node, the hard-spread pods within skew 1
          over the zones, cnt_final equal to the counts of the placements,
          the kernel bit-equal to its plain version at a locality round's
          inputs; the host encode ms, the warm solve median, a device
          profile of one solve, and each kernel call's rows, CUDA-event ms
          and bound
  topology a pod-slice fleet under a wave of multi-host jobs
          (client/synthetic.make_topology_fleet / make_gang_pods). At the
          cut (1,024 nodes in 32 ICI domains x 768 asks) the steered
          solve_batch on `cuda` and `cpu` bit-identical in all five outputs,
          and one core cycle (solver.topology auto) on each binding
          identically by pod name with equal topology metrics; at 10,240
          nodes in 320 domains x 7,680 asks the un-steered and the steered
          solve on `cuda`, each with the JAX package's rounds, placed count
          and one-domain gang ratio, best_nodes launched (its launches read
          around the steered run) with the bonus and bit-equal at a steered
          round's inputs, no node oversubscribed, every placement inside its
          static feasibility; the fold's host ms, the warm solve median
          (steered and not), a device profile, each kernel call's ms and
          bound, and the plain version's ms at the last steered round
  preempt the device preemption planner: 32 asks against 10,000 nodes of
          victims (victim tables [16,384, 16, R]) on `cuda`, plan for plan
          equal to the host planner and to the JAX package's counts,
          dispatch and finish ms, the node and victim mirrors full on the
          first dispatch and clean on the next two, the HtoD ms of a
          profiled dispatch + finish on a clean mirror and right after
          discard_device_mirror; then the quota-held trace through the
          port's core on `cuda` and on `cpu`, evicting what the JAX core
          evicts
  gate    the admission gate: scripts/gate_bench.py's backlog
          (client/synthetic's copy) at 50,000 asks in the default,
          contended and saturated shapes, device_admit on `cuda` equal to
          host_scan (admitted order, held count) within its pass bound,
          admit ms / device ms / passes of both gates; then one
          quota-bound core cycle (5,000 asks on the contended tree) on
          `cuda` with gateDevice auto binding as one with gateDevice=False
          and one on `cpu`
  duel    the duel arms (solver.policy=optimal): the random streams on
          the card equal to the CPU's (keys, split, fold_in, bits, uniform,
          permutation(65,536)) and a Gumbel draw over [16, 4,096, 1,024]
          within 1e-6 of the CPU's on its first and last parts; the pack
          arm at scripts/pack_bench.py's three shapes and the cvx arm at
          scripts/cvx_bench.py's four (client/synthetic.make_pack_nodes /
          make_pack_pods, arm seed 7): each plan feasible, greedy's plan
          exactly the JAX package's, each arm's normalized units within
          0.5% of EXPECTED_PACK / EXPECTED_CVX, the pack plan winning the
          largest shape's duel as the JAX package's does, warm ms (median
          of 5 after a warm-up); the core with solver.policy=optimal at
          full width (the pressure mix, 10,000 x 50,000: 16 parts, random
          partitioner; a warm-up cycle, then the measured one) with its
          stage split, pack_plan_ms, winner, pack_util, no node over its
          allocatable, and best_nodes' launches counted from 0 around the
          cycle, split between the greedy dispatch and the pack repair;
          the core on the topology cut (the ICI-domain partitioner); the
          core with solver.pack=cvx at the pressure cut (16,384 x 2,048
          cells, the budget's edge); MockScheduler with solver.policy
          optimal on the 1,024 x 128 fleet, pods in the cluster before
          start: pack_plans_total won >= 1, none failed, more bound than a
          greedy run; and a device profile of a full-width pack solve and
          a cut cvx solve, with the Gumbel draw of one rounding round and
          the row projection of one primal step timed alone
  learned the learned policy (solver.policy=learned and all) with the
          committed checkpoint tests/data/policy_fragmented_v1 (the JAX
          package's trainer's output, hash LEARNED_HASH): learned_propose
          against its plain version on the card at full width (N 65,536,
          M 16,384, E 16, R 8; also E 8 and 32, no row active, R 12): nf
          equal, lmean within 1e-6, picks and proposals equal off near-ties
          (counted), and best_nodes' learned term bit-equal (with the
          bonus and a row mask); the kernel's CUDA-event ms, the plain
          version's and the bound; scripts/policy_bench.py's evaluation at
          512 x 4,096: greedy exactly the JAX package's (323 placed,
          258.053 units), learned within 0.5% of its 512 / 401.439 and the
          duel won by learned, the untrained checkpoint's plan bit-identical
          to greedy's, warm ms of both; the core with solver.policy=learned
          at full width (the pressure mix, 10,000 x 50,000) with every
          kernel's launches counted from 0 around the measured cycle, its
          stage split, learned_ms, winner and learned_util, no node over
          its allocatable, and then the untrained checkpoint's learned plan
          equal to the greedy plan; solver.policy=all on the pressure mix at
          ALL_CUT_NODES x ALL_CUT_PODS (1,000 x 6,000) on the card and on
          the CPU (the same winner, every arm's units within
          0.5%, the cvx arm's learned duals); and a device profile of one
          full-width learned solve
  train   the learned policy's trainer: scripts/policy_bench.py --train
          at its defaults through the port (TRAIN_CYCLES greedy-vs-pack
          duels at TRAIN_SHAPE recorded on the card into a DatasetWriter;
          fit on the card with TRAIN_EPOCHS twice, the same params hash,
          and once on the CPU; each checkpoint evaluated at 512 x 4,096,
          the card's winning with learned units >= TRAIN_MIN_WIN x
          greedy's and no fewer placed; ms a step of each phase, fit
          seconds), then at full width: the optimal core's cycle on the
          pressure mix (10,000 x 50,000) recorded by core.policy_recorder
          (one example of N 65,536 x M 16,384), a fit of FULL_FIT_EPOCHS
          on the card at that shape (ms a step, peak memory), and the
          checkpoint served by the learned core at full width: no failed
          learned plan, every binding fits its node, both kernels'
          launches counted from 0 around that cycle
  shim    the port's shim and MockScheduler on `cuda`, the path a user's
          pods take (informers -> application and task state machines ->
          dispatcher -> core -> allocation callback -> bind pool -> binding
          at the fake API server): bench.py's shim run (10,000 kwok nodes x
          50,000 sleep pods in 5 queues, added before start, WARN logging)
          binding all 50,000 within SHIM_DEADLINE_S (else the phase fails
          with its partial count), every solve on the device tier, no failed
          cycle, no node over its allocatable at the fake API server; the
          bound count, the wall time, first-to-last-bind pods/s
          (BindStats.throughput, as bench.py reports it), the warm cycles'
          stage split, the host threads' sampled split; then the pressure
          mix at SHIM_CUT_NODES x SHIM_CUT_PODS (1,000 x 5,000) through a
          hand-run harness (the
          core not started: the shim's pump delivers every ask, then
          schedule_once until a cycle places nothing) on `cuda` and on
          `cpu`: identical allocations by pod name, the JAX package's count
          under the same harness, best_nodes launched
  cmd     `python -m yunikorn_tpu_torch.cmd.scheduler --nodes 1000 --pods
          5000` in a subprocess: /ws/v1/nodes reaches 1,000,
          a profile started over REST and stopped 3 s later, while the pods
          stream in, writes a trace holding CUDA kernels, every pod binds,
          /metrics carries the core's series, SIGTERM exits 0 within 30 s
          with the
          --trace-out JSON written, and the child's log names device=cuda
  kube    the binary with --kubeconfig, on the card, against
          tests/fake_apiserver.py's server started in this process (the
          client/kube reflectors over HTTP): CMD_NODES nodes at the server
          before start, CMD_PODS sleep pods added in waves of KUBE_WAVE, the
          event log compacted and every watch killed once halfway (the
          reflectors reconnect, get 410 Gone and relist); every pod bound at
          the server exactly once, /metrics valid under the port's
          obs/promtext and carrying informer_restarts_total and
          informer_last_sync_age_seconds, SIGTERM exits 0 within 30 s;
          nodes_ready_s, all_bound_s, pods/s from the first bind to the
          last, the informers' restarts, the first cycle's ms and the
          cycles' mean stage ms, and when after the first pod the core
          first held an app, an ask and an allocation (/ws/v1/apps, polled
          every KUBE_POLL_S until the first allocation), the server its
          first binding, and the dispatcher's backlog between the two
          (/ws/v1/health, every KUBE_POLL_S)
  admit   the admission webhook in front of the scheduler: the port's
          admission controller binary (`python -m
          yunikorn_tpu_torch.cmd.admission_controller --kubeconfig`, over
          TLS when `cryptography` imports, else --no-tls, printed as "tls"
          with the import error) and scheduler binary (--kubeconfig, on the
          card) against tests/fake_apiserver.py's server in this process,
          which holds CMD_NODES nodes, the yunikorn-configs configmap
          (admissionController.filtering.processNamespaces ADMIT_PROCESS)
          and a priority class annotated allow-preemption "false". With
          TLS both webhook configurations are installed at the server with
          one caBundle, and every call verifies the webhook's certificate
          against it as the only CA. This process plays the API server's
          admission step for ADMIT_PODS bare pods (no schedulerName, no
          applicationId) over ADMIT_NAMESPACES from ADMIT_THREADS threads:
          POST /mutate, apply the JSON patch, create the pod. Each patch
          must equal what the reference's controller writes (the port's
          constants: schedulerName, the applicationId and queue labels, the
          user-info annotation, the allow-preemption annotation from the
          priority class); the excluded namespace's pods get no scheduler
          name and no labels. The configmap is then updated at the server
          to process the excluded namespace, and ADMIT_RELOAD_PODS more
          there must come back patched (the informers' hot reload). A port
          AdmissionController whose validate_conf_fn POSTs queues.yaml to
          the scheduler's /ws/v1/validate-conf denies an invalid
          configuration and allows a valid one; the binary's own
          /validate-conf allows both (no validator, as the reference's).
          Every patched pod is bound exactly once, under the applicationId
          its patch gave it (/ws/v1/apps), and no excluded pod; the port's
          webapp/webtest proxies /ws/v1/apps and /ws/v1/nodes equal to a
          direct read; SIGTERM exits both binaries 0 within 30 s; the
          /mutate round trip's p50 / p99 ms, pods/s from the first
          admission to the last bind, and the first bind after the first
          admission
  replay  yunikorn_tpu_torch.cmd.trace_replay's run_replay on the card,
          every best_nodes and learned_propose call captured and held
          against its plain version afterwards (best_nodes bit-equal;
          learned_propose by check_proposals), each run's launches counted
          from 0: (A) gang-storm at the JAX replay's acceptance shape
          (REPLAY_STORM: 10,000 nodes, 900 pods, 6 tenants, 30 s): pass,
          all five verdicts ok, every pod bound, the fingerprint, warm-up,
          first cycle, trace, drain and wall seconds and the e2e p99; (B)
          the policy round trip (REPLAY_POLICY, slice-fragmentation at
          1,024 nodes x 768 pods): a recording under solver.policy=optimal
          with --dataset-out holding at least one duel cycle, a fit on the
          card by `python -m yunikorn_tpu_torch.cmd.policy_train` of
          POLICY_FIT_EPOCHS, and the greedy, optimal and learned arms with
          the new checkpoint: the learned arm serving it, binding no fewer
          pods than greedy and launching learned_propose; (C) restart-storm
          with a fresh-process takeover (REPLAY_TAKEOVER_COLD, no store):
          every
          bound pod restored, none lost, none mis-evicted, the child's
          first cycle ms; (D) gang-storm under contention
          (REPLAY_CONTENTION: 1,024 nodes, 1,800 pods of 5 cores, 30 s; the
          third storm outgrows the fleet until completions free room):
          pass, all five verdicts ok, every pod bound, best_nodes launched
          in the odd rounds and every call held
  shard   the sharded control plane: usage_apply / usage_fold on the card
          bit-equal to the CPU and a DeviceUsageMirror on the card at
          divergence 0 through MIRROR_OPS ledger operations with epoch
          fences; scripts/shard_bench.py's wave (SHARD_SHAPE: 20,000 asks,
          10,000 nodes, 640 ICI domains, streamed in bursts of 256) at 1
          and SHARD_COUNT shards through make_core_scheduler on the card:
          placed and packed at 4 shards >= SHARD_MIN_QUALITY x 1 shard's,
          the ledger's audit empty, the mirror at divergence 0, every
          best_nodes call of both runs (captured on the shard threads)
          bit-equal to best_nodes_reference, pods/s of each and the
          speedup; scripts/failover_bench.py's cell (10,000 nodes, 4
          shards, 1,024 pods bound, a second wave, then
          quarantine_shard(1)) on a queue with a max, so every bind
          charges the ledger and the shards' cycles drain its deltas into
          the mirror on the card: every node it owned re-homed, every ask
          bound, a late refresh with the dead shard's old epoch fenced,
          the audit empty and the mirror equal to the ledger's confirmed
          usage after each phase, quarantine_s and recover_s; and the
          binary with --shards 2 --ledger-serve: every
          pod bound (/ws/v1/shards), yunikorn_shard_count 2 at /metrics,
          SIGTERM exits 0
  mesh    node-dim sharding (parallel/mesh) on MESH_SHARDS node shards of
          the card (set_mesh_devices([cuda:0] * MESH_SHARDS), restored
          after), every result held against the single-device one computed
          in the phase on the card: the pressure solve (MAIN_NODES x
          MAIN_PODS) through solve_sharded with assigned / accept_round /
          free_after / rounds equal, the
          JAX package's 16 rounds / 45,977 placed, best_nodes launched once
          a shard in each odd round (32, counted from 0 around that run) and
          every call held against the plain version with its keys; the
          kernel at the first odd round's inputs cut into the shards
          (node_offset / m_total / keys_out): each shard's keys equal to the
          plain version's, the merged keys equal to the unsharded call, each
          shard call's ms, plain ms and bound; the warm median of 3 of both
          solves; the chained form at max_batch MESH_CHUNK_BATCH; the
          locality solve at the cut and the steered gang wave (TOPO_*) with
          their JAX package's counts; the preemption planner at
          PREEMPT_NODES x PREEMPT_ASKS plan for plan; the usage mirror with
          mesh= (sharded_fold, divergence 0, fleet totals equal to a mirror
          on the card); pack_solve_sharded at the largest PACK_SHAPES bit
          equal to pack_solve(partitioner="topo", n_shards=MESH_SHARDS); a
          CoreScheduler(shard=True) against shard=False at bench.py's core
          shape (cold and warm cycle: the warm mirror clean, 0 node bytes)
          and at the pressure cut, pod for pod, the mesh circuit closed with
          0 failures and replicated_bytes in last_cycle; the learned solve
          at MAIN_NODES x MAIN_PODS with the committed checkpoint through
          solve_sharded(learned=), every output equal, learned_propose
          launched once a shard a round and its finish once a round (counted
          from 0 around that run), every shard call (keys, nf, slice sums)
          and finish held against the plain version, the odd rounds'
          best_nodes shard calls with the learned term held, round 0's
          shard calls' and finish's ms, plain ms and bound, the warm
          medians, and the eval shape's EXPECTED_LEARNED; cvx_solve_sharded
          against cvx_solve_batch at the CVX_SHAPES and the pressure cut,
          with and without the checkpoint's duals, plans and free_after
          equal (EXPECTED_CVX held); learned and cvx cores with shard=True
          against shard=False at the cut, pod for pod, each duel recording
          its arm. "cards" is the card count; with more than one card every
          check runs again over the real cards ("real_cards": peer copies
          between them)
  kernels one line per kernel: launches (the wrapper's count of calls in
          the main path's run; launches_locality, launches_topology,
          launches_duel (launches_duel_repair of them in the pack arm's
          repair), launches_learned (launches_learned_arm of them in the
          learned solve), launches_shim, launches_train,
          launches_replay_*, launches_shard, launches_warm,
          launches_mesh and launches_mesh_learned: in the
          locality and topology paths' full-width runs, the optimal and the
          learned core's full-width cycles, the shim's pressure run, the
          trained checkpoint's learned cycle, each replay run, the 4-shard
          wave, the warm phase's prewarm child on the card and the mesh
          phase's sharded pressure and learned solves; for
          learned_propose the learned core's cycle, the trained
          checkpoint's and the replay's learned arm and the mesh phase's
          sharded learned solve, each a count of shard calls, with
          launches_finish / launches_mesh_finish the finish's), error
          against the
          plain version (max_abs_err_shard / max_abs_err_replay /
          max_abs_err_warm / max_abs_err_mesh: over the shard wave's / the
          replays' / the prewarm's / the sharded solve's calls,
          held_shard_calls / held_replay_calls / held_warm_calls /
          held_mesh_calls of them; null when no call was held;
          mesh_shard_ms / mesh_shard_bound_ms: each node shard's call at the
          first odd round's inputs), kernel /
          plain /
          bound milliseconds (best_nodes at the first odd round's inputs,
          as the main path calls it; learned_propose at full-width random
          inputs)

The last two lines are the card's name and power limit, and the result.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM (NVIDIA data sheet; CUDA C++ Programming Guide, "Throughput of
# Native Arithmetic Instructions", compute capability 9.0): HBM bytes/s, SMs,
# and results per clock per SM of 32-bit compares, min/max and bitwise ops
# (64) and of f32 adds (128). The clock is the card's clocks.max.sm.
PEAK_BYTES_S = 3.35e12
SMS = 132
CMP_PER_CLK_SM = 64
FADD_PER_CLK_SM = 128
# the float32 peak outside the tensor cores, used by the first slice's bound
# (kept to restate that bound beside the corrected one)
OLD_PEAK_OPS_S = 67e12
MAIN_NODES, MAIN_PODS = 10_000, 50_000
# the solve's padded shape at MAIN_NODES x MAIN_PODS (pods N, nodes M)
FULL_SHAPE = (65_536, 16_384)
CUT_NODES, CUT_PODS = 2_000, 10_000
# the learned phase's solver.policy=all cycle, on the card and on the CPU:
# a quarter of CUT_NODES x CUT_PODS's padded cells (8,192 x 1,024). At the
# full cut its CPU cycle (every arm on the host's cores) took 87.4 s of the
# script's 757.7 on the H100 machine's host, at this shape 24.6 s. Its
# decision is the full cut's: pack and cvx place every pod and tie on
# units, cvx wins the incumbent fold, learned places fewer, card = CPU. (At
# 1,000 x 7,000 the cvx arm placed 7,000 on the card and 6,993 on the CPU,
# which flipped the winner: the relaxations' float noise, ROADMAP §3.)
ALL_CUT_NODES, ALL_CUT_PODS = 1_000, 6_000
# the JAX package's result on the same workloads (rounds, pods placed)
EXPECTED = {(MAIN_NODES, MAIN_PODS): (16, 45_977),
            (CUT_NODES, CUT_PODS): (16, 9_455)}
# pods placed by the JAX package's CoreScheduler (CPU) in one cycle of the
# pressure mix at the cut, driven as phase_core drives the port's
EXPECTED_CORE_CUT = 9_455
# the JAX package's solve_batch on the locality mix (make_locality_pods on
# make_pressure_nodes): (rounds, pods placed)
EXPECTED_LOCALITY = {(MAIN_NODES, MAIN_PODS): (16, 39_328),
                     (CUT_NODES, CUT_PODS): (16, 8_009)}
# the topology workload (client/synthetic.make_topology_fleet and
# make_gang_pods: scripts/topology_bench.py's build), as (pods, nodes,
# domains): ten times the bench's default 768 x 1,024 x 32, and that cut
TOPO_PODS, TOPO_NODES, TOPO_DOMAINS = 7_680, 10_240, 320
TOPO_CUT_PODS, TOPO_CUT_NODES, TOPO_CUT_DOMAINS = 768, 1_024, 32
# the JAX package's solve_batch on it, steered (build_topo_args with
# app_rows={}) and not: rounds, pods placed, share of gangs in one domain
EXPECTED_TOPOLOGY = {
    (TOPO_PODS, TOPO_NODES, TOPO_DOMAINS): {
        "on": {"rounds": 16, "placed": 7_541, "one_domain_ratio": 1.0},
        "off": {"rounds": 16, "placed": 7_312,
                "one_domain_ratio": 0.5891218872870249}},
    (TOPO_CUT_PODS, TOPO_CUT_NODES, TOPO_CUT_DOMAINS): {
        "on": {"rounds": 16, "placed": 763, "one_domain_ratio": 1.0},
        "off": {"rounds": 16, "placed": 745,
                "one_domain_ratio": 0.5578231292517006}}}
# the JAX package's CoreScheduler (CPU, solver.topology auto) on the cut's
# gang wave, driven as topology_cut drives the port's: pods placed, and its
# topology metrics and last_cycle topology keys
EXPECTED_TOPOLOGY_CORE_CUT = (752, {
    "topology_gangs_total": 147, "topology_cross_domain_gangs_total": 0,
    "topology_domain_fragmentation": 0.967725,
    "topo_fragmentation": 0.967725, "topo_gangs": 147, "topo_domains": 32,
    "topo_cycle_gangs": 147, "topo_cycle_cross_domain": 0})
# the preemption workload (tests/test_preempt_solve.py's build_cluster at
# 10,000 nodes, seed 0, one cycle's ask budget) and the JAX package's
# plan_preemptions_batched on it: (plans, victims), and its first three
# plans as (ask pod, node, victim pods)
PREEMPT_NODES, PREEMPT_ASKS = 10_000, 32
EXPECTED_PREEMPT = (32, 32)
EXPECTED_PREEMPT_FIRST = [("hi-0-1", "n00005", ["v-5-0"]),
                          ("hi-0-3", "n00001", ["v-1-2"]),
                          ("hi-0-4", "n00007", ["v-7-0"])]
# the JAX core's quota-held trace with preempt_device=True: (evicted pods,
# asks held by quota)
EXPECTED_QUOTA_HELD = (["qv-0"], 5)
# the admission gate's backlog (scripts/gate_bench.py's build) and the
# quota-bound core cycle's ask count
GATE_ASKS = 50_000
GATE_CORE_ASKS = 5_000
# the duel phase: scripts/pack_bench.py's shapes (pods, nodes) and
# scripts/cvx_bench.py's (pods, nodes, gang) on client/synthetic's
# two-flavor fleet (make_pack_nodes / make_pack_pods, fleet seed 0), the
# arms' seed DUEL_SEED
PACK_SHAPES = ((1_024, 128), (2_048, 256), (4_096, 512))
CVX_SHAPES = ((2_048, 1_024, 0), (2_048, 1_024, 8), (4_096, 4_096, 0),
              (4_096, 4_096, 8))
DUEL_SEED = 7
# the JAX package's plans on them (CPU): the duel's winner, and each arm's
# (placed, capacity-normalized units); the card's units must lie within
# DUEL_UNITS_RTOL of these, its greedy plan on them (the same placed count,
# units to 1e-9: a float64 sum over the placed rows, whose order numpy
# versions may change)
EXPECTED_PACK = {
    (1_024, 128): ("optimal", {"greedy": (366, 291.95454545454544),
                               "optimal": (544, 426.77090909090913)}),
    (2_048, 256): ("optimal", {"greedy": (719, 574.0427272727272),
                               "optimal": (996, 787.699090909091)}),
    (4_096, 512): ("optimal", {"greedy": (1_355, 1082.1363636363635),
                               "optimal": (2_060, 1624.0645454545452)})}
EXPECTED_CVX = {
    (2_048, 1_024, 0): ("cvx", {"greedy": (1_205, 961.4190909090908),
                                "optimal": (2_048, 1601.8863636363635),
                                "cvx": (2_048, 1601.8863636363635)}),
    (2_048, 1_024, 8): ("cvx", {"greedy": (1_205, 961.4190909090908),
                                "optimal": (2_048, 1601.8863636363635),
                                "cvx": (2_048, 1601.8863636363635)}),
    (4_096, 4_096, 0): ("cvx", {"greedy": (2_297, 1834.3836363636362),
                                "optimal": (4_096, 3203.592727272727),
                                "cvx": (4_096, 3203.592727272727)}),
    (4_096, 4_096, 8): ("cvx", {"greedy": (2_297, 1834.3836363636362),
                                "optimal": (4_096, 3203.592727272727),
                                "cvx": (4_096, 3203.592727272727)})}
DUEL_UNITS_RTOL = 0.005
# the pack arm's per-round noise at full width: (parts, asks, nodes) of a
# part
DUEL_NOISE_SHAPE = (16, 4_096, 1_024)
# the MockScheduler duel: the pack bench's smallest shape as pods
DUEL_MOCK_PODS, DUEL_MOCK_NODES = 1_024, 128
# the shim phase: bench.py's shim run (10,000 kwok nodes x 50,000 sleep
# pods in 5 queues) must bind every pod within SHIM_DEADLINE_S
SHIM_DEADLINE_S = 240.0
# the JAX package's MockScheduler (CPU) on the pressure mix at
# SHIM_CUT_NODES x SHIM_CUT_PODS, driven by the same hand-run harness as
# shim_harness drives the port's (tests/test_torch_shim.py --cut prints
# it): pods placed, and the pods each schedule_once placed until one
# placed none. The harness ran at CUT_NODES x CUT_PODS (10,000 in cycles
# 9,455 / 534 / 11 / 0) until its card and CPU runs were cut to half the
# pods for the script's time; the odd rounds are still reached
SHIM_CUT_NODES, SHIM_CUT_PODS = 1_000, 5_000
EXPECTED_SHIM_CUT = (5_000, [4_940, 60, 0])
# the cmd phase: the scheduler binary with 1,000 synthetic nodes and a
# stream of 5,000 sleep pods (its --pods: 200 a second), profiled over
# CMD_PROFILE_S seconds of the stream
CMD_NODES, CMD_PODS = 1_000, 5_000
CMD_PROFILE_S = 3.0
# the learned phase: the committed checkpoint (the JAX package's trainer,
# scripts/policy_bench.py --train at its defaults) and its content hash;
# policy_bench's eval shape (pods, nodes, fleet seed) and the learned
# solve's seed there; the JAX package's plans at it (placed, units to 3
# decimals, as policy_bench reports them) and the duel's winner. The
# learned arm's units must lie within LEARNED_UNITS_RTOL of its; greedy's
# are exact
LEARNED_CKPT = os.path.join(ROOT, "tests", "data", "policy_fragmented_v1")
LEARNED_HASH = "083e3b745ed6202c"
LEARNED_EVAL = (512, 4_096, 99)
LEARNED_SEED = 1
EXPECTED_LEARNED = ("learned", {"greedy": (323, 258.053),
                                "learned": (512, 401.439)})
LEARNED_UNITS_RTOL = 0.005
# kernel against plain: picks whose top two scores lie within
# LEARNED_NEAR_TIE may differ (the card's logf against torch's log), and
# the gate on rows within it of the margin; lmean within LEARNED_LMEAN_TOL
# times max(1, |lmean|) (both sum the feasible scores in float64, in other
# orders, and round the mean once to float32: they differ only where the
# two float64 sums straddle a float32 rounding boundary)
LEARNED_NEAR_TIE = 1e-5
LEARNED_LMEAN_TOL = 1e-6
# the learned proposal pass's work per fitting pair on the card: 32-bit
# integer operations (threefry2x32's 20 rounds of add, rotate and xor, its
# 5 key injections, the counter and the uniform's shift and or), logf
# calls (the special-function unit), and float32 operations besides the
# dot product's 2E - 1 (the noise's scale and add, the uniform's
# subtract, add and max, the compare)
LEARNED_INT_OPS, LEARNED_SFU_OPS, LEARNED_FP_OPS = 74, 2, 6
SFU_PER_CLK_SM = 16
# the train phase: scripts/policy_bench.py --train's defaults (cycles of
# TRAIN_SHAPE pods x nodes on the two-flavor fleet, fleet seeds 0..3, the
# epochs of each phase) and its --assert-quality bar on learned/greedy
# units; the full-width fit's epochs (a cut of depth: the JAX trainer's
# defaults are 80 + 60)
TRAIN_SHAPE = (256, 128)
TRAIN_CYCLES = 4
TRAIN_EPOCHS = (60, 40)
TRAIN_MIN_WIN = 1.05
FULL_FIT_EPOCHS = (3, 3)
# the shard phase: scripts/shard_bench.py's round-16 table shape (pods,
# nodes, ICI domains), its seed, cycle interval and quality bar, the
# sharded count it compares against 1; scripts/failover_bench.py's cell
# (nodes, shards, pods); the binary's run with --shards 2 --ledger-serve
SHARD_SHAPE = (20_000, 10_000, 640)
SHARD_SEED = 7
SHARD_INTERVAL = 0.005
SHARD_MIN_QUALITY = 0.97
SHARD_COUNT = 4
FAILOVER_NODES, FAILOVER_SHARDS, FAILOVER_PODS = 10_000, 4, 1_024
# the failover cell's queue: a max every pod charges (so each bind
# reserves and commits through the ledger, whose deltas the usage mirror
# drains on the card) and that still admits the cell's 1,280 pods of
# 200 millicores and 128 MiB
FAILOVER_QUEUES = """
partitions:
  - name: default
    queues:
      - name: root
        queues:
          - name: capped
            resources:
              max: {vcore: 512, memory: 512Gi}
"""
SHARD_CMD_NODES, SHARD_CMD_PODS = 1_000, 2_000
# the usage mirror's check: ledger operations and trackers
MIRROR_OPS, MIRROR_TRACKERS = 4_096, 48
# the kube phase: the binary with --kubeconfig against the fake API server
# at the cmd phase's shape (CMD_NODES nodes, CMD_PODS sleep pods added at
# the server in waves of KUBE_WAVE every KUBE_WAVE_GAP_S seconds; the
# watches are killed and the event log compacted once, halfway)
KUBE_WAVE, KUBE_WAVE_GAP_S = 500, 0.5
# how often the kube phase reads the core's state (/ws/v1/apps, then the
# dispatcher's backlog at /ws/v1/health) until the first binding
KUBE_POLL_S = 0.2
# the replay phase, through yunikorn_tpu_torch.cmd.trace_replay's
# run_replay on the card: (A) the JAX replay's acceptance shape,
# gang-storm at 10,000 nodes with its defaults (900 pods, 6 tenants, 30 s,
# seed 42, interval 0.05); (B) `make policy-smoke`'s replay half, a
# slice-fragmentation replay recorded under solver.policy=optimal
# (--dataset-out), a fit on the card of POLICY_FIT_EPOCHS, and the
# three-arm A/B with the new checkpoint; (C) `make failover-smoke`'s
# fresh-process takeover without a store
# (A), (B) and (D) run without the bucket prewarm (--no-prewarm), as they
# ran before the replay had one; (C) here is the cold takeover, and the warm
# phase runs it again on a store, with the prewarm
REPLAY_STORM = ["--trace", "gang-storm", "--nodes", "10000", "--no-prewarm"]
REPLAY_POLICY = ["--trace", "slice-fragmentation", "--nodes", "1024",
                 "--pods", "768", "--tenants", "4", "--duration", "12",
                 "--no-prewarm"]
POLICY_FIT_EPOCHS = (30, 20)
REPLAY_TAKEOVER = ["--trace", "restart-storm", "--nodes", "300", "--pods",
                   "240", "--tenants", "4", "--duration", "14",
                   "--restart-mode", "process", "--takeover-window", "25",
                   "--slo-cold-budget-ms", "120000"]
REPLAY_TAKEOVER_COLD = REPLAY_TAKEOVER + ["--no-prewarm"]
# (D) gang-storm under contention: the replay's own --overcommit makes each
# pod 5 cores, one to an 8-core node; the storms of 600 pods on 1,024 nodes
# (30 s: each storm binds for 6 s before half of the bound pods complete)
# fit until the third (1,200 live), whose overflow waits for the second
# storm's completions, so the cycles reach the odd rounds. 1,024 lies in
# [1.5, 2) x 600: the end state (900 live) fits once each completion finds
# its 300 pods bound
REPLAY_CONTENTION = ["--trace", "gang-storm", "--nodes", "1024", "--pods",
                     "1800", "--overcommit", "50", "--no-prewarm"]
# the warm phase: cmd/aot_smoke's three fresh children (cold, hit, prewarm)
# at the JAX smoke's bucket, the prewarm child's first cycle within
# WARM_MAX_RATIO of its warm cycles'; the binary at the kube phase's shape
# (CMD_NODES nodes, one wave of KUBE_WAVE pods) with --aot-store and
# --prewarm WARM_KUBE_BUCKET; replay C's takeover on the phase's store
WARM_BUCKET = "1024x10240"
WARM_MAX_RATIO = 3.0
WARM_KUBE_BUCKET = f"{CMD_NODES}x{KUBE_WAVE}"
# the admit phase: the port's admission controller binary (--kubeconfig)
# and scheduler binary against the fake API server. ADMIT_PODS pods created
# bare (no schedulerName, no applicationId) go through /mutate from
# ADMIT_THREADS threads, spread over ADMIT_NAMESPACES; the last one is left
# out by admissionController.filtering.processNamespaces until the configmap
# at the server is updated, after which ADMIT_RELOAD_PODS more there must
# come back patched. Every ADMIT_PC_EVERY-th pod of the processed
# namespaces names ADMIT_PRIORITY_CLASS, annotated allow-preemption "false"
ADMIT_PODS, ADMIT_RELOAD_PODS, ADMIT_THREADS = 2_000, 200, 8
ADMIT_NAMESPACES = ("team-a", "team-b", "team-c", "excluded")
ADMIT_PROCESS, ADMIT_PROCESS_RELOADED = "^team-", "^team-,^excluded$"
ADMIT_PRIORITY_CLASS, ADMIT_PC_EVERY = "no-preempt", 10
ADMIT_USER = {"username": "alice", "groups": ["dev"]}
# the scheduler's /ws/v1/validate-conf behind the admission controller's
# validate_conf_fn seam: a partition with no root queue is refused
ADMIT_INVALID_QUEUES = ("partitions:\n  - name: default\n    queues:\n"
                        "      - name: notroot\n")
ADMIT_VALID_QUEUES = ("partitions:\n  - name: default\n    queues:\n"
                      "      - name: root\n        submitacl: '*'\n")
# the mesh phase: node shards on the one card, and the chained form's slice
MESH_SHARDS = 4
MESH_CHUNK_BATCH = 16_384
# the mesh phase's `orders` part: the (padded pods, node capacity) of the
# CVX_SHAPES and of the pressure cut, and the fleet widths the node tower
# is embedded at (the CVX_SHAPES', the cut's and the main path's)
MESH_ORDER_SHAPES = ((2_048, 1_024), (4_096, 4_096), (16_384, 2_048))
MESH_TOWER_WIDTHS = (1_024, 2_048, 4_096, 16_384)
KERNELS = [{
    "name": "best_nodes",
    "route": "cuda",
    "source": "yunikorn_tpu_torch/csrc/best_nodes.cu",
    "replaces": "yunikorn_tpu/ops/pallas_kernels.py:53",
}, {
    "name": "learned_propose",
    "route": "cuda",
    "source": "yunikorn_tpu_torch/csrc/learned_propose.cu",
    "replaces": "yunikorn_tpu/ops/assign.py:821",
}]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up.
    The runs queue behind a ~20 ms sleep kernel, so that the host is ahead
    of the device and the events time the device rather than the host's
    launch rate."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pair_counts(req, group_id, group_feas, free, rows=None,
                chunk: int = 1024):
    """Over the requested rows (every row when rows is None): the (row,
    node) pairs whose group row admits the node, and those of them where
    the node's free row covers the request."""
    N, R = req.shape
    G = group_feas.shape[0]
    gid = group_id.long().clamp(0, G - 1)
    idx = (rows.nonzero().squeeze(1) if rows is not None
           else torch.arange(N, device=req.device))
    admitted = int(group_feas.sum(dim=1)[gid[idx]].sum())
    fitting = 0
    for s in range(0, idx.shape[0], chunk):
        i = idx[s:s + chunk]
        ok = group_feas[gid[i]]
        for r in range(R):
            ok &= free[:, r][None, :] >= req[i, r][:, None]
        fitting += int(ok.sum())
    return int(idx.shape[0]), admitted, fitting


def best_nodes_bound_ms(req, group_id, group_feas, free, has_soft: bool,
                        clock_hz: float, rows=None,
                        bonus: bool = False, emb: int = 0) -> dict:
    """Least time for one best-node call: inputs read once and outputs
    written once over HBM bandwidth, against the operations these inputs
    need at the compare/logic rate. Each admitted pair (a requested row and
    a node its group admits) costs R fit compares; each compare also ANDs
    the running fit predicate, in the same instruction on this card
    (ISETP takes a predicate input). Each fitting pair costs one max. The
    score add is one f32 add per (group, node) at the f32 rate. With the
    planned-domain bonus (topology steering) each fitting pair costs one
    more compare (the domain match), each (group, node) one more add (the
    rounded + 8.0), and node_dom [M] and pref [N] are read. With the
    learned term (embeddings of width emb) each fitting pair costs emb
    products and emb adds at the f32 rate, and pod_emb [N, emb] and
    node_emb [M, emb] are read. Also returns the first slice's formula
    (every pod x every node, 2R + 1 + soft lane operations over the 67
    TFLOP/s float32 peak) as `old_ms`."""
    N, R = req.shape
    G, M = group_feas.shape
    nbytes = (N * R * 4 + N * 4 + G * M + (G * M * 4 if has_soft else 0)
              + M * R * 4 + M * 4 + N * 4 + N
              + ((M + N) * 4 if bonus else 0) + (M + N) * emb * 4)
    n_rows, admitted, fitting = pair_counts(req, group_id, group_feas, free,
                                            rows)
    cmp_s = ((admitted * R + fitting * (2 if bonus else 1))
             / (CMP_PER_CLK_SM * SMS * clock_hz))
    adds = ((G * M if has_soft else 0) + (G * M if bonus else 0)
            + fitting * 2 * emb)
    add_s = adds / (FADD_PER_CLK_SM * SMS * clock_hz)
    t_ops = (cmp_s + add_s) * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    old_ms = max(N * M * (2 * R + 1 + int(has_soft)) / OLD_PEAK_OPS_S * 1e3,
                 t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": by,
            "rows": n_rows, "pairs": admitted, "fitting_pairs": fitting,
            "old_ms": old_ms}


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def random_kernel_inputs(rng, N, M, G, R, dev):
    """Inputs shaped like the solve's: base scores and soft terms on coarse
    grids so that many scores tie."""
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(
        req=t(rng.integers(1, 100, (N, R)).astype(np.int32)),
        group_id=t(rng.integers(0, G, (N,)).astype(np.int32)),
        group_feas=t(rng.random((G, M)) < 0.7),
        group_soft=t((rng.integers(-4, 2, (G, M)) * 0.25).astype(np.float32)),
        free=t(rng.integers(0, 200, (M, R)).astype(np.int32)),
        base_scores=t((rng.integers(0, 32, (M,)) / 32.0).astype(np.float32)),
    )


def phase_build():
    from yunikorn_tpu_torch.utils import torchtools

    t0 = time.perf_counter()
    torchtools.build_all([k["name"] for k in KERNELS])
    for k in KERNELS:
        torchtools.load_library(k["name"])
    # ptxas's report of each kernel variant: registers, shared memory, spills
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in torchtools.build_logs.items()}
    return {"build_s": time.perf_counter() - t0, "ptxas": ptxas}


def slice_edge_ties(inp, S):
    """Equal scores everywhere, and each group admits only the nodes just
    around every multiple of S, where the kernel may split the node range
    across blocks: ties that straddle slice boundaries."""
    G, M = inp["group_feas"].shape
    edge = torch.zeros_like(inp["group_feas"])
    for b in range(S, M, S):
        edge[:, b - 2:b + 2] = True
    return dict(inp, group_feas=edge,
                base_scores=torch.full_like(inp["base_scores"], 0.5),
                group_soft=torch.zeros_like(inp["group_soft"]))


def random_rows(rng, N, count, dev):
    rows = np.zeros(N, bool)
    rows[rng.choice(N, count, replace=False)] = True
    return torch.from_numpy(rows).to(dev)


def phase_kernel(dev):
    from yunikorn_tpu_torch.ops.best_nodes import (best_nodes,
                                                   best_nodes_reference,
                                                   slice_nodes)

    rng = np.random.default_rng(20261016)
    cases = []
    N, M, R = 65_536, 16_384, 8
    for G in (4, 8):
        base = random_kernel_inputs(rng, N, M, G, R, dev)
        variants = [("random", base, {})]
        if G == 4:
            none = dict(base, group_feas=torch.zeros_like(base["group_feas"]))
            tie = dict(base, base_scores=torch.full_like(base["base_scores"], 0.5),
                       group_soft=torch.zeros_like(base["group_soft"]))
            ragged = random_kernel_inputs(rng, 4_000, M - 77, G, R, dev)
            some = random_rows(rng, N, N * 3 // 10, dev)
            variants += [
                ("all_infeasible", none, {}), ("forced_tie", tie, {}),
                ("ragged_m", ragged, {}),
                ("rows_30pct", base, {"rows": some}),
                ("rows_none", base, {"rows": torch.zeros_like(some)}),
                ("rows_129", base, {"rows": random_rows(rng, N, 129, dev)}),
                ("slice_edge_ties", slice_edge_ties(base, slice_nodes()),
                 {"rows": some})]
        else:
            wide = random_kernel_inputs(rng, N, M, G, 12, dev)
            variants += [
                ("r12", wide, {}),
                ("r12_slice_edge_ties", slice_edge_ties(wide, slice_nodes()),
                 {"rows": random_rows(rng, N, 5_000, dev)})]
        for label, inp, kw in variants:
            for mode in ("exact", "quantized"):
                for has_soft in (True, False):
                    got = best_nodes(**inp, mode=mode, has_soft=has_soft, **kw)
                    torch.cuda.synchronize()
                    ref = best_nodes_reference(**inp, mode=mode,
                                               has_soft=has_soft, **kw)
                    equal = (bool(torch.equal(got[0], ref[0]))
                             and bool(torch.equal(got[1], ref[1])))
                    err = int((got[0].long() - ref[0].long()).abs().max())
                    cases.append({"case": label, "G": G,
                                  "N": inp["req"].shape[0],
                                  "M": inp["free"].shape[0],
                                  "R": inp["req"].shape[1], "mode": mode,
                                  "has_soft": has_soft, "equal": equal,
                                  "max_abs_err": err,
                                  "feasible": int(got[1].sum())})
    cases += bonus_cases(rng, dev)
    bad = [c for c in cases if not c["equal"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version: {bad}")
    return {"cases": len(cases), "all_equal": True, "tolerance": 0,
            "labels": sorted({c["case"] for c in cases}),
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


def bonus_inputs(rng, N, M, G, R, D, dev, rounding_ties=False):
    """Kernel inputs with the planned-domain bonus: pref [N] in [0, D) with
    a quarter of the rows -1 (unsteered), node_dom [M] in [0, D) with a
    tenth of the nodes -1 (unlabeled). rounding_ties: base scores 2^-24
    apart near 0.5 and no soft term, which the + 8.0 of the bonus rounds
    onto one float: ties that exist only on the bonus."""
    inp = random_kernel_inputs(rng, N, M, G, R, dev)
    if rounding_ties:
        base = (np.float32(0.5) + (np.arange(M) % 64).astype(np.float32)
                * np.float32(2.0**-24)).astype(np.float32)
        inp = dict(inp, base_scores=torch.from_numpy(base).to(dev),
                   group_soft=torch.zeros_like(inp["group_soft"]))
    pref = rng.integers(0, D, (N,)).astype(np.int32)
    pref[rng.random(N) < 0.25] = -1
    node_dom = rng.integers(0, D, (M,)).astype(np.int32)
    node_dom[rng.random(M) < 0.1] = -1
    return inp, {"node_dom": torch.from_numpy(node_dom).to(dev),
                 "pref": torch.from_numpy(pref).to(dev)}


def bonus_cases(rng, dev):
    """The planned-domain bonus (exact mode) against its plain version at
    the topology path's shapes (N = 8,192 pods, M = 16,384 nodes, D = 512
    domains): random, ties made only by the + 8.0 rounding, a 30% row
    mask, every row unsteered, ties straddling the kernel's node slices
    inside one domain, and R = 12."""
    from yunikorn_tpu_torch.ops.best_nodes import (best_nodes,
                                                   best_nodes_reference,
                                                   slice_nodes)

    N, M, G, R, D = 8_192, 16_384, 4, 8, 512
    base, steer = bonus_inputs(rng, N, M, G, R, D, dev)
    ties, ties_steer = bonus_inputs(rng, N, M, G, R, D, dev,
                                    rounding_ties=True)
    wide, wide_steer = bonus_inputs(rng, N, M, G, 12, D, dev)
    some = random_rows(rng, N, N * 3 // 10, dev)
    # four nodes around each slice boundary share one domain
    edge_dom = ((torch.arange(M, device=dev) + 32) // 64 % D).to(torch.int32)
    variants = [
        ("bonus_random", base, steer, {}),
        ("bonus_rounding_ties", ties, ties_steer, {}),
        ("bonus_rows_30pct", base, steer, {"rows": some}),
        ("bonus_unsteered", base,
         dict(steer, pref=torch.full_like(steer["pref"], -1)), {}),
        ("bonus_slice_edge_ties", slice_edge_ties(base, slice_nodes()),
         dict(steer, node_dom=edge_dom), {"rows": some}),
        ("bonus_r12", wide, wide_steer, {})]
    cases = []
    for label, inp, st, kw in variants:
        for has_soft in (True, False):
            got = best_nodes(**inp, has_soft=has_soft, **st, **kw)
            torch.cuda.synchronize()
            ref = best_nodes_reference(**inp, has_soft=has_soft, **st, **kw)
            equal = (bool(torch.equal(got[0], ref[0]))
                     and bool(torch.equal(got[1], ref[1])))
            err = int((got[0].long() - ref[0].long()).abs().max())
            case = {"case": label, "G": G, "N": N, "M": M,
                    "R": inp["req"].shape[1], "mode": "exact",
                    "has_soft": has_soft, "equal": equal,
                    "max_abs_err": err, "feasible": int(got[1].sum())}
            if label in ("bonus_random", "bonus_rounding_ties"):
                # the bonus must move some answer (it is not a no-op)
                plain = best_nodes(**inp, has_soft=has_soft, **kw)
                case["moved"] = int((plain[0] != got[0]).sum())
                case["equal"] = equal and case["moved"] > 0
            cases.append(case)
    return cases


def build_workload(n_nodes, n_pods, make_pods=None):
    """The pressure fleet of n_nodes and n_pods of make_pods (default: the
    pressure mix), encoded: (encoder, batch, pods, host encode ms)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    for node in make_pressure_nodes(n_nodes):
        cache.update_node(node)
    pods = (make_pods or make_pressure_pods)(n_pods)
    asks = [AllocationAsk(p.uid, p.metadata.labels["applicationId"],
                          get_pod_resource(p), pod=p) for p in pods]
    enc = SnapshotEncoder(cache)
    t0 = time.perf_counter()
    enc.sync_nodes(full=True)
    batch = enc.build_batch(asks, ranks=list(range(len(asks))))
    encode_ms = (time.perf_counter() - t0) * 1e3
    return enc, batch, pods, encode_ms


SOLVE_KW = dict(max_rounds=16, chunk=512, policy="binpacking",
                max_batch=65536)


def phase_cut(dev):
    from yunikorn_tpu_torch.ops.assign import solve_batch

    enc, batch, pods, _ = build_workload(CUT_NODES, CUT_PODS)
    n = len(pods)
    on_card = solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
    torch.cuda.synchronize()
    on_cpu = solve_batch(batch, enc.nodes, device="cpu", **SOLVE_KW)
    same = {f: bool(torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)))
            for f in ("assigned", "accept_round", "free_after")}
    same["rounds"] = on_card.rounds == on_cpu.rounds
    placed = int((on_card.assigned[:n] >= 0).sum())
    if not all(same.values()):
        raise AssertionError(f"cuda and cpu paths differ: {same}")
    expected = EXPECTED[(CUT_NODES, CUT_PODS)]
    if (on_card.rounds, placed) != expected:
        raise AssertionError(f"rounds/placed {(on_card.rounds, placed)} != "
                             f"{expected}")
    return {"nodes": CUT_NODES, "pods": CUT_PODS, "identical": same,
            "rounds": on_card.rounds, "placed": placed}


def check_placements(batch, enc, res, n, dev):
    """No node oversubscribed, free_after = free - scatter(requests), and
    every placement allowed by its group's feasibility row."""
    from yunikorn_tpu_torch.ops import assign

    np_args, _ = assign.prepare_solve_args(batch, enc.nodes)
    (req, group_id, _rank, _valid, free, _cap, group_feas,
     *_) = assign._prepare(np_args[:assign._ARG_LOC], None, dev)
    a = res.assigned.long()
    placed = a >= 0
    if not bool((res.free_after >= 0).all()):
        raise AssertionError("a node is oversubscribed")
    expect = free.long().index_add(0, a[placed], -req[placed].long())
    if not torch.equal(expect, res.free_after.long()):
        raise AssertionError("free_after != free - scatter(assigned requests)")
    if not bool(group_feas[group_id.long()[placed], a[placed]].all()):
        raise AssertionError("a pod was placed on a node its group excludes")
    if bool(placed[n:].any()):
        raise AssertionError("a padding row was placed")


@contextlib.contextmanager
def capturing_best_nodes():
    """Route ops/assign's best_nodes through a spy that keeps a copy of
    every call's inputs, cloned on the thread (and so the stream) that
    made the call; yields the list of (args, kwargs)."""
    from yunikorn_tpu_torch.ops import assign
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    captured = []

    def spy(*args, **kwargs):
        captured.append(([a.clone() for a in args],
                         {k: v.clone() if isinstance(v, torch.Tensor) else v
                          for k, v in kwargs.items()}))
        return best_nodes(*args, **kwargs)

    assign.best_nodes = spy
    try:
        yield captured
    finally:
        assign.best_nodes = best_nodes


@contextlib.contextmanager
def capturing_learned_propose():
    """Route ops/assign's learned_propose_shard and learned_propose_finish
    (the kernel's two parts, as the solve's rounds call them: a shard call
    a node shard, one finish) through spies that keep a copy of every
    call's arguments by name (cloned on the calling thread); yields
    {"shard": [dicts], "finish": [dicts]}."""
    import inspect

    from yunikorn_tpu_torch.ops import assign
    from yunikorn_tpu_torch.ops import learned as lmod

    real = {"shard": lmod.learned_propose_shard,
            "finish": lmod.learned_propose_finish}
    captured = {"shard": [], "finish": []}

    def spy(kind):
        fn = real[kind]
        sig = inspect.signature(fn)

        def run(*args, **kwargs):
            bound = sig.bind(*args, **kwargs).arguments
            captured[kind].append(
                {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in bound.items()})
            return fn(*args, **kwargs)
        return run

    assign.learned_propose_shard = spy("shard")
    assign.learned_propose_finish = spy("finish")
    try:
        yield captured
    finally:
        assign.learned_propose_shard = real["shard"]
        assign.learned_propose_finish = real["finish"]


def whole_call(inp):
    """A captured shard call of a solve without a mesh (node_offset 0 over
    all m_total nodes) as learned_propose's keyword arguments."""
    if inp.get("node_offset", 0) or inp.get(
            "m_total", inp["free"].shape[0]) != inp["free"].shape[0]:
        raise AssertionError("not a call over all nodes")
    return {k: v for k, v in inp.items() if k not in ("node_offset",
                                                       "m_total")}


def hold_calls(captured, where):
    """Each captured best_nodes call again through the kernel and through
    best_nodes_reference: raises unless both outputs are bit-equal;
    returns the largest |best - best_ref| (0), or None when nothing was
    captured (no error was measured)."""
    from yunikorn_tpu_torch.ops.best_nodes import (best_nodes,
                                                   best_nodes_reference)

    if not captured:
        return None
    err = 0
    for args, kwargs in captured:
        got = best_nodes(*args, **kwargs)
        ref = best_nodes_reference(*args, **kwargs)
        err = max(err, int((got[0].long() - ref[0].long()).abs().max()))
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"kernel differs from plain at {where}")
    return err


def solve_capturing(batch, enc, dev):
    """One solve_batch on `dev` with the kernel's launch count set to 0
    just before it and read just after, and a copy of every best_nodes
    call's inputs: (result, captured calls, launches, host ms)."""
    from yunikorn_tpu_torch.ops import assign
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    with capturing_best_nodes() as captured:
        best_nodes.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = best_nodes.launches
    return res, captured, launches, first_ms


def warm_solve_ms(batch, enc, dev, runs=5):
    from yunikorn_tpu_torch.ops import assign

    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def odd_round_calls(captured, clock_hz):
    """Each captured best_nodes call again at its own inputs: the rows it
    requested, CUDA-event ms and the bound for those rows."""
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    calls = []
    for k, (args, kwargs) in enumerate(captured):
        b = best_nodes_bound_ms(args[0], args[1], args[2], args[4],
                                kwargs.get("has_soft", True), clock_hz,
                                rows=kwargs.get("rows"),
                                bonus=kwargs.get("pref") is not None)
        ms = cuda_ms(lambda: best_nodes(*args, **kwargs), 10)
        calls.append({"round": 2 * k + 1, "rows": b["rows"], "ms": ms,
                      "bound_ms": b["bound_ms"], "pairs": b["pairs"],
                      "fitting_pairs": b["fitting_pairs"]})
    return calls


def phase_main(dev, stats, clock_hz):
    from yunikorn_tpu_torch.ops import assign, best_nodes as bn_mod
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    enc, batch, pods, encode_ms = build_workload(MAIN_NODES, MAIN_PODS)
    n = len(pods)
    res, captured, n_launch, first_ms = solve_capturing(batch, enc, dev)
    launches = {"best_nodes": n_launch}
    placed = int((res.assigned[:n] >= 0).sum())
    accepted = res.accept_round[res.accept_round >= 0].long()
    per_round = torch.bincount(accepted, minlength=res.rounds).tolist()
    if launches["best_nodes"] < 1:
        raise AssertionError("the main path launched no best_nodes kernel")
    expected = EXPECTED[(MAIN_NODES, MAIN_PODS)]
    if (res.rounds, placed) != expected:
        raise AssertionError(f"rounds/placed {(res.rounds, placed)} != "
                             f"{expected}")
    check_placements(batch, enc, res, n, dev)

    solve_ms = warm_solve_ms(batch, enc, dev)

    t0 = time.perf_counter()
    assign.prepare_solve_args(batch, enc.nodes)
    prepare_ms = (time.perf_counter() - t0) * 1e3
    profile = profile_solve(
        lambda: assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW))
    # what the card runs for the solve's best_nodes calls: each call is a
    # memset of the row count, then the prep, main and finish kernels
    pieces = profile_solve(
        lambda: [best_nodes(*a, **kw) for a, kw in captured])
    piece_rows = pieces.get("top", [])
    device_launches = sum(r["count"] for r in piece_rows
                          if not r["name"].startswith("Memset"))
    memsets = sum(r["count"] for r in piece_rows
                  if r["name"].startswith("Memset"))

    # each odd round's call again, at its own inputs: CUDA-event ms and the
    # corrected bound for the rows it requested
    odd_rounds = odd_round_calls(captured, clock_hz)
    solve_kernel_ms = sum(r["ms"] for r in odd_rounds)
    solve_bound_ms = sum(r["bound_ms"] for r in odd_rounds)

    args, kwargs = captured[0]
    full_kwargs = {k: v for k, v in kwargs.items() if k != "rows"}
    kernel_ms = cuda_ms(lambda: best_nodes(*args, **kwargs), 20)
    full_ms = cuda_ms(lambda: best_nodes(*args, **full_kwargs), 20)
    plain_ms = cuda_ms(lambda: bn_mod.best_nodes_reference(*args, **kwargs), 3)
    err = 0
    for kw in (kwargs, full_kwargs):
        got = best_nodes(*args, **kw)
        ref = bn_mod.best_nodes_reference(*args, **kw)
        err = max(err, int((got[0].long() - ref[0].long()).abs().max()))
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError("kernel differs from plain on main-path "
                                 "inputs")
    has_soft = kwargs.get("has_soft", True)
    masked_b = best_nodes_bound_ms(args[0], args[1], args[2], args[4],
                                   has_soft, clock_hz, rows=kwargs.get("rows"))
    full_b = best_nodes_bound_ms(args[0], args[1], args[2], args[4], has_soft,
                                 clock_hz)
    # update: the warm phase, which runs first, put its counts there
    stats.setdefault("best_nodes", {}).update({
        "launches": launches["best_nodes"], "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": masked_b["bound_ms"], "bound_by": masked_b["bound_by"],
        "library_ms": None,
    })
    mirror = main_mirror(batch, enc, pods, res, dev)
    N, R = args[0].shape
    G, M = args[2].shape
    return {"nodes": MAIN_NODES, "pods": MAIN_PODS, "N": N, "M": M, "G": G,
            "R": R, "rounds": res.rounds, "placed": placed,
            "placed_per_round": per_round,
            "launches": launches,
            "best_nodes_card_work": {
                "calls": len(captured), "kernel_launches": device_launches,
                "memsets": memsets,
                "device_ms": pieces.get("device_busy_ms"),
                "share_of_solve_device_busy": (
                    pieces["device_busy_ms"] / profile["device_busy_ms"]
                    if "device_busy_ms" in pieces
                    and profile.get("device_busy_ms") else None),
                "pieces": piece_rows},
            "encode_ms": encode_ms,
            "first_solve_ms": first_ms,
            "warm_solve_ms_median": statistics.median(solve_ms),
            "warm_solve_ms": solve_ms, "mode": kwargs.get("mode"),
            "clock_max_sm_mhz": clock_hz / 1e6,
            "odd_rounds": odd_rounds,
            "kernel_ms_per_solve": solve_kernel_ms,
            "bound_ms_per_solve": solve_bound_ms,
            "share_per_solve": solve_bound_ms / solve_kernel_ms,
            "masked": {"rows": masked_b["rows"], "ms": kernel_ms,
                       "bound_ms": masked_b["bound_ms"],
                       "share": masked_b["bound_ms"] / kernel_ms},
            "full": {"rows": full_b["rows"], "ms": full_ms,
                     "bound_ms": full_b["bound_ms"],
                     "share": full_b["bound_ms"] / full_ms,
                     "first_slice_formula_bound_ms": full_b["old_ms"]},
            "plain_on_card_ms": plain_ms,
            "host_prepare_ms": prepare_ms, "profile": profile,
            "mirror": mirror}


def main_mirror(batch, enc, pods, host_res, dev):
    """The main path on the encoder's device-resident state, as the core
    solves it: the request rows from the row store (all rows, then a 1%
    churn that must upload only the churned rows) and the node arrays from
    the persistent mirror (a full upload, then clean: 0 bytes). The solve
    on the mirror equals the host-array solve; warm ms on the mirror; the
    HtoD ms of a profiled warm solve on the host arrays, on a clean mirror,
    and right after discard_device_mirror (a full upload), in this run."""
    from yunikorn_tpu_torch.ops import assign

    asks = asks_of(pods)
    for i, a in enumerate(asks):
        a.seq = i
    req = enc.device_req(asks, batch, device=dev)
    store = enc.row_store
    if not np.array_equal(req.cpu().numpy(), batch.req.astype(np.int32)):
        raise AssertionError("the row store's req differs from batch.req")
    rows_first = store.last_upload_rows
    churn = len(asks) // 100
    for a in asks[:churn]:
        a.seq += len(asks)
    t0 = time.perf_counter()
    churned = enc.device_req(asks, batch, device=dev)
    torch.cuda.synchronize()
    churn_ms = (time.perf_counter() - t0) * 1e3
    if store.last_upload_rows != churn:
        raise AssertionError(f"a {churn}-ask churn uploaded "
                             f"{store.last_upload_rows} rows")
    if not torch.equal(churned, req):
        raise AssertionError("a same-request churn changed the gathered req")
    batch.req_device = req

    def on_mirror():
        return assign.solve_batch(batch, enc.nodes, device=dev,
                                  device_state=enc.device_arrays(device=dev),
                                  **SOLVE_KW)

    try:
        res = on_mirror()
        full = (enc.device.last_refresh, enc.device.take_upload_bytes())
        same = {f: bool(torch.equal(getattr(res, f), getattr(host_res, f)))
                for f in ("assigned", "accept_round", "free_after")}
        same["rounds"] = res.rounds == host_res.rounds
        if not all(same.values()):
            raise AssertionError(f"the solve on the mirror differs: {same}")
        warm = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            on_mirror()
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        clean = (enc.device.last_refresh, enc.device.take_upload_bytes())
        if clean != ("clean", 0):
            raise AssertionError(f"a warm solve with nothing changed "
                                 f"refreshed {clean}")
        prof_clean = profile_solve(on_mirror)
        enc.discard_device_mirror()
        prof_full = profile_solve(on_mirror)
        after_discard = (enc.device.last_refresh,
                         enc.device.take_upload_bytes())
    finally:
        batch.req_device = None
    prof_host = profile_solve(lambda: assign.solve_batch(
        batch, enc.nodes, device=dev, **SOLVE_KW))
    return {"equals_host_arrays_solve": same,
            "row_store": {"upload_rows": rows_first,
                          "churn_upload_rows": churn,
                          "churn_sync_ms": churn_ms},
            "first": {"node_refresh": full[0], "node_upload_bytes": full[1]},
            "warm": {"node_refresh": clean[0], "node_upload_bytes": clean[1],
                     "solve_ms": warm,
                     "solve_ms_median": statistics.median(warm)},
            "after_discard": {"node_refresh": after_discard[0],
                              "node_upload_bytes": after_discard[1]},
            "htod_ms": {"host_arrays": prof_host.get("htod_ms"),
                        "mirror_clean": prof_clean.get("htod_ms"),
                        "mirror_after_discard": prof_full.get("htod_ms")},
            "device_busy_ms": {
                "host_arrays": prof_host.get("device_busy_ms"),
                "mirror_clean": prof_clean.get("device_busy_ms"),
                "mirror_after_discard": prof_full.get("device_busy_ms")},
            "profile_mirror_clean": prof_clean}


class NullCallback:
    """The core's ResourceManagerCallback as bench.py's core cycle uses it:
    it keeps the placements (allocation key -> node) and counts the rest."""

    def __init__(self):
        self.bound = {}
        self.skipped = 0

    def update_allocation(self, response):
        for a in response.new:
            self.bound[a.allocation_key] = a.node_id
        for r in response.released:
            self.bound.pop(r.allocation_key, None)

    def update_application(self, response):
        pass

    def update_node(self, response):
        pass

    def predicates(self, args):
        return None

    def preemption_predicates(self, args):
        return None

    def send_event(self, events):
        pass

    def update_container_scheduling_state(self, request):
        self.skipped += 1

    def get_state_dump(self):
        return "{}"


def make_core(device, nodes, apps, solver=None):
    """A port CoreScheduler on `device` (with SolverOptions `solver`, else
    the defaults) with `nodes` registered in its cache and at the core,
    and `apps` as (app id, queue) on dynamic queues (no queues.yaml, as
    bench.py's core cycle)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.common import si
    from yunikorn_tpu_torch.core.scheduler import CoreScheduler

    cache = SchedulerCache()
    core = CoreScheduler(cache, device=device, solver_options=solver)
    cb = NullCallback()
    core.register_resource_manager(si.RegisterResourceManagerRequest(
        rm_id="smoke", policy_group="queues"), cb)
    infos = []
    for n in nodes:
        cache.update_node(n)
        infos.append(si.NodeInfo(node_id=n.name, action=si.NodeAction.CREATE))
    core.update_node(si.NodeRequest(nodes=infos))
    for app_id, queue in apps:
        core.update_application(si.ApplicationRequest(new=[
            si.AddApplicationRequest(application_id=app_id, queue_name=queue,
                                     user=si.UserGroupInfo(user="smoke"))]))
    return cache, core, cb


def asks_of(pods):
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk

    return [AllocationAsk(p.uid, p.metadata.labels["applicationId"],
                          get_pod_resource(p), pod=p) for p in pods]


def core_cycle(core, asks):
    """Submit asks and run one schedule_once: (placed, host seconds)."""
    from yunikorn_tpu_torch.common.si import AllocationRequest

    core.update_allocation(AllocationRequest(asks=list(asks)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = core.schedule_once()
    torch.cuda.synchronize()
    return n, time.perf_counter() - t0


def release_all(core, asks):
    from yunikorn_tpu_torch.common.si import (AllocationRelease,
                                              AllocationRequest,
                                              TerminationType)

    core.update_allocation(AllocationRequest(releases=[
        AllocationRelease(a.application_id, a.allocation_key,
                          TerminationType.STOPPED_BY_RM) for a in asks]))
    core.schedule_once()


def check_tiers(core, where):
    """Every assign solve of the core served by its device tier, no cycle
    failed and the solve's circuit closed."""
    m = core.metrics
    tiers = m.get("solve_tier_total") or {}
    if set(tiers) != {"tier=device"}:
        raise AssertionError(f"{where}: solves served by tiers {tiers}")
    if m.get("scheduling_cycle_failures_total"):
        raise AssertionError(f"{where}: failed cycles "
                             f"{m['scheduling_cycle_failures_total']}")
    circuits = core.supervisor.snapshot()["assign"]["circuits"]
    if circuits != {"device": {"state": "closed", "failures": 0}}:
        raise AssertionError(f"{where}: assign circuits {circuits}")
    return int(sum(tiers.values()))


def cycle_split(core):
    entry = dict(core.metrics["last_cycle"]["default"])
    return {k: entry.get(k) for k in (
        "pods", "gate_ms", "gate_rank_ms", "gate_admit_ms", "gate_device_ms",
        "gate_passes", "encode_ms", "solve_ms", "commit_ms", "post_ms",
        "total_ms", "pipelined", "solve_tier", "gate_path", "node_refresh",
        "node_upload_bytes", "encode_device_rows", "encode_device_bytes",
        "encode_device_ms")}


def full_width_prewarm(core, dev, core_peak):
    """One --prewarm bucket at the core shape (utils/torchtools
    .warm_bucket with the core, MAIN_NODES x MAIN_PODS): its peak device
    allocation above what was allocated before it, against the live core's
    peak over a warm cycle (`core_peak`). The prewarm runs on a thread
    beside the first cycles on the same card, so the two peaks and what
    is allocated outside them must fit the card together."""
    from yunikorn_tpu_torch.utils.torchtools import warm_bucket

    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    info = warm_bucket(MAIN_NODES, MAIN_PODS, core=core)
    peak = torch.cuda.max_memory_allocated(dev) - base
    total = torch.cuda.get_device_properties(dev).total_memory
    out = {"bucket": f"{MAIN_NODES}x{MAIN_PODS}", "seconds": info["seconds"],
           "solves": info["solves"],
           "best_nodes_calls": info["best_nodes_calls"],
           "prewarm_peak_bytes": peak, "core_warm_cycle_peak_bytes": core_peak,
           "allocated_before_bytes": base, "card_bytes": total,
           "together_share": (base + peak + core_peak) / total}
    if info["solves"] != 4 or info["best_nodes_calls"] != 1:
        raise AssertionError(f"the full-width prewarm: {out}")
    if base + peak + core_peak > total:
        raise AssertionError(f"the prewarm beside a cycle would not fit the "
                             f"card: {out}")
    return out


def core_bench_shape(dev):
    """bench.py's core cycle (bench.py:806-859) on the port's core."""
    from yunikorn_tpu_torch.client.synthetic import (make_kwok_nodes,
                                                     make_sleep_pods)
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    queues = [(f"bench-app-{q}", f"root.q{q}") for q in range(5)]
    _, core, _ = make_core(dev, make_kwok_nodes(MAIN_NODES), queues)
    pods = []
    for app, queue in queues:
        pods += make_sleep_pods(MAIN_PODS // 5, app, queue=queue,
                                name_prefix=queue.split(".")[-1])
    asks = asks_of(pods)
    n_warmup, warmup_s = core_cycle(core, asks[:512])
    warmup_split = cycle_split(core)
    release_all(core, asks[:512])
    n_cold, cold_s = core_cycle(core, asks)
    cold_cycle_split = cycle_split(core)
    release_all(core, asks)
    before = best_nodes.launches
    torch.cuda.synchronize(dev)
    mem_base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    n_warm, warm_s = core_cycle(core, asks)
    core_peak = torch.cuda.max_memory_allocated(dev) - mem_base
    warm_launches = best_nodes.launches - before
    split = cycle_split(core)
    if (n_warmup, n_cold, n_warm) != (512, MAIN_PODS, MAIN_PODS):
        raise AssertionError(f"placed {(n_warmup, n_cold, n_warm)}, expected "
                             f"(512, {MAIN_PODS}, {MAIN_PODS})")
    # one more warm cycle under torch.profiler: the device's busy time and
    # idle share over a whole cycle (the profiler lengthens the host side)
    from yunikorn_tpu_torch.common.si import AllocationRequest

    release_all(core, asks)
    core.update_allocation(AllocationRequest(asks=list(asks)))
    profile = profile_solve(core.schedule_once, top=8)
    clean_split = cycle_split(core)
    if (clean_split["node_refresh"], clean_split["node_upload_bytes"]) != (
            "clean", 0):
        raise AssertionError(f"a warm cycle with no node change refreshed "
                             f"the mirror: {clean_split}")
    # the same warm cycle right after the mirror is discarded: one full
    # upload (the HtoD of the per-cycle transfer the mirror removes)
    release_all(core, asks)
    core.update_allocation(AllocationRequest(asks=list(asks)))
    core.encoder.discard_device_mirror()
    profile_full = profile_solve(core.schedule_once, top=8)
    full_split = cycle_split(core)
    if full_split["node_refresh"] != "full":
        raise AssertionError(f"after a discard the mirror refreshed "
                             f"{full_split['node_refresh']}")
    # a 1% churn cycle: 500 placed pods released and submitted again (a
    # fresh core seq each): the row store uploads their rows only
    churn = asks[:MAIN_PODS // 100]
    release_all(core, churn)
    n_churn, churn_s = core_cycle(core, churn)
    churn_split = cycle_split(core)
    if (n_churn, churn_split["encode_device_rows"]) != (len(churn),
                                                        len(churn)):
        raise AssertionError(f"churn cycle placed {n_churn}, uploaded "
                             f"{churn_split['encode_device_rows']} rows")
    prewarm_mem = full_width_prewarm(core, dev, core_peak)
    solves = check_tiers(core, "core-cycle shape")
    return {"nodes": MAIN_NODES, "pods": MAIN_PODS,
            "placed": {"warmup": n_warmup, "cold": n_cold, "warm": n_warm},
            "pods_per_s": n_warm / warm_s, "warm_cycle_ms": warm_s * 1e3,
            "cold_cycle_ms": cold_s * 1e3, "warmup_cycle_ms": warmup_s * 1e3,
            "cold_first_cycle_ms": core.metrics.get("cold_first_cycle_ms"),
            "warm_split": split, "cold_cycle_split": cold_cycle_split,
            "cold_split": core.cold_split(), "prewarm_memory": prewarm_mem,
            "warmup_split": warmup_split, "solves": solves, "tiers": "device",
            "degradations": 0, "warm_best_nodes_launches": warm_launches,
            "profiled_warm_cycle": profile,
            "profiled_warm_cycle_split": clean_split,
            "profiled_after_discard": profile_full,
            "profiled_after_discard_split": full_split,
            "htod_ms": {"mirror_clean": profile.get("htod_ms"),
                        "mirror_after_discard": profile_full.get("htod_ms")},
            "churn_cycle": {"pods": n_churn, "cycle_ms": churn_s * 1e3,
                            "split": churn_split}}


def check_bindings(cache, bound, asks):
    """No node oversubscribed (the bound requests on each node fit its
    allocatable) and every binding satisfies its pod's node selector and
    hard taints."""
    from yunikorn_tpu_torch.common.resource import Resource
    from yunikorn_tpu_torch.ops.host_predicates import (node_selector_matches,
                                                        tolerates_node_taints)

    by_key = {a.allocation_key: a for a in asks}
    used = {}
    for key, node in bound.items():
        ask = by_key[key]
        info = cache.get_node(node)
        if not (node_selector_matches(ask.pod, info.node)
                and tolerates_node_taints(ask.pod, info.node)):
            raise AssertionError(f"{ask.pod.metadata.name} bound to {node} "
                                 "against its selector or taints")
        used[node] = used.get(node, Resource()).add(ask.resource)
    for node, total in used.items():
        if not total.fits_in(cache.get_node(node).allocatable):
            raise AssertionError(f"node {node} oversubscribed: {total}")
    return len(used)


def core_pressure(dev):
    """The pressure mix through the core: one cycle, the kernel's launches
    read around it, and the placements held against a direct solve_batch
    on the batch the core encoded."""
    from yunikorn_tpu_torch.client.synthetic import (PRESSURE_APPS,
                                                     make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.core import scheduler as sched
    from yunikorn_tpu_torch.ops import assign
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(PRESSURE_APPS))]
    cache, core, cb = make_core(dev, make_pressure_nodes(MAIN_NODES), apps)
    asks = asks_of(make_pressure_pods(MAIN_PODS))
    calls = []

    def spy(batch, node_arrays, **kw):
        res = assign.solve_batch(batch, node_arrays, **kw)
        calls.append((batch, node_arrays, kw, res.assigned.cpu(), res.rounds))
        return res

    sched.solve_batch = spy
    try:
        best_nodes.launches = 0
        n, cycle_s = core_cycle(core, asks)
        launches = best_nodes.launches
    finally:
        sched.solve_batch = assign.solve_batch
    if launches < 1:
        raise AssertionError("the core's pressure cycle launched no "
                             "best_nodes kernel")
    check_tiers(core, "pressure")
    if len(calls) != 1:
        raise AssertionError(f"{len(calls)} solves in one cycle")
    batch, nodes, kw, assigned, rounds = calls[0]
    if kw.get("device") != dev:
        raise AssertionError(f"the core solved on {kw.get('device')}")
    direct = assign.solve_batch(batch, nodes, **kw)
    if not torch.equal(direct.assigned.cpu(), assigned):
        raise AssertionError("the core's solve differs from a direct "
                             "solve_batch on the batch it encoded")
    rows = assigned[:batch.num_pods].tolist()
    expect = {batch.ask_keys[i]: nodes.name_of(r)
              for i, r in enumerate(rows) if r >= 0}
    if cb.bound != expect:
        raise AssertionError("the core's bindings differ from the direct "
                             "solve's placements")
    used_nodes = check_bindings(cache, cb.bound, asks)
    if n != len(cb.bound):
        raise AssertionError(f"schedule_once said {n}, bound {len(cb.bound)}")
    expected = EXPECTED[(MAIN_NODES, MAIN_PODS)]
    if (rounds, n) != expected:
        raise AssertionError(f"the core's (rounds, placed) {(rounds, n)} != "
                             f"the JAX package's {expected}")
    return {"nodes": MAIN_NODES, "pods": MAIN_PODS, "placed": n,
            "rounds": rounds, "expected": list(expected),
            "best_nodes_launches": launches,
            "cycle_ms": cycle_s * 1e3, "split": cycle_split(core),
            "skipped": cb.skipped, "nodes_used": used_nodes,
            "equals_direct_solve": True, "oversubscribed": 0}


def core_cut(dev):
    """One cycle of the pressure mix at the cut on `cuda` and on `cpu`:
    identical bindings as pod name -> node (pod uids embed a process-wide
    counter, so names are the comparable key)."""
    from yunikorn_tpu_torch.client.synthetic import (PRESSURE_APPS,
                                                     make_pressure_nodes,
                                                     make_pressure_pods)

    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(PRESSURE_APPS))]
    out, binds = {}, {}
    for label, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        _, core, cb = make_core(device, make_pressure_nodes(CUT_NODES), apps)
        pods = make_pressure_pods(CUT_PODS)
        names = {p.uid: p.metadata.name for p in pods}
        n, cycle_s = core_cycle(core, asks_of(pods))
        check_tiers(core, f"cut on {label}")
        binds[label] = {names[k]: v for k, v in cb.bound.items()}
        out[label] = {"placed": n, "cycle_ms": cycle_s * 1e3}
    if binds["cuda"] != binds["cpu"]:
        diff = sum(binds["cuda"].get(k) != v for k, v in binds["cpu"].items())
        raise AssertionError(f"cuda and cpu cores bind differently ({diff} "
                             "pods)")
    if out["cuda"]["placed"] != EXPECTED_CORE_CUT:
        raise AssertionError(f"placed {out['cuda']['placed']} != the JAX "
                             f"core's {EXPECTED_CORE_CUT}")
    return {"nodes": CUT_NODES, "pods": CUT_PODS, "identical": True,
            "expected_placed": EXPECTED_CORE_CUT, **out}


def phase_core(dev):
    return {"bench_shape": core_bench_shape(dev),
            "pressure": core_pressure(dev), "cut": core_cut(dev)}


def locality_cut(dev):
    """The locality mix at the cut: solve_batch on `cuda` and on `cpu`
    bit-identical in all five outputs, and one core cycle on each binding
    identically by pod name."""
    from yunikorn_tpu_torch.client.synthetic import (LOCALITY_APPS,
                                                     make_locality_pods,
                                                     make_pressure_nodes)
    from yunikorn_tpu_torch.ops.assign import solve_batch

    enc, batch, pods, _ = build_workload(CUT_NODES, CUT_PODS,
                                         make_locality_pods)
    on_card = solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
    torch.cuda.synchronize()
    on_cpu = solve_batch(batch, enc.nodes, device="cpu", **SOLVE_KW)
    same = {f: bool(torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)))
            for f in ("assigned", "accept_round", "free_after", "cnt_final")}
    same["rounds"] = on_card.rounds == on_cpu.rounds
    if not all(same.values()):
        raise AssertionError(f"cuda and cpu locality solves differ: {same}")
    placed = int((on_card.assigned[:len(pods)] >= 0).sum())
    if (on_card.rounds, placed) != EXPECTED_LOCALITY[(CUT_NODES, CUT_PODS)]:
        raise AssertionError(f"rounds/placed {(on_card.rounds, placed)} != "
                             f"{EXPECTED_LOCALITY[(CUT_NODES, CUT_PODS)]}")

    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(LOCALITY_APPS))]
    out, binds = {}, {}
    for label, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        _, core, cb = make_core(device, make_pressure_nodes(CUT_NODES), apps)
        cut_pods = make_locality_pods(CUT_PODS)
        names = {p.uid: p.metadata.name for p in cut_pods}
        n, cycle_s = core_cycle(core, asks_of(cut_pods))
        check_tiers(core, f"locality cut on {label}")
        binds[label] = {names[k]: v for k, v in cb.bound.items()}
        out[label] = {"placed": n, "cycle_ms": cycle_s * 1e3}
    if binds["cuda"] != binds["cpu"]:
        diff = sum(binds["cuda"].get(k) != v for k, v in binds["cpu"].items())
        raise AssertionError(f"cuda and cpu cores bind the locality mix "
                             f"differently ({diff} pods)")
    return {"nodes": CUT_NODES, "pods": CUT_PODS, "solve_identical": same,
            "rounds": on_card.rounds, "placed": placed,
            "core_identical": True, "core": out}


def check_locality(batch, enc, res, pods, dev):
    """The locality rules held by the placements: no two anti-affinity pods
    on one node, max - min of the hard-spread pods over the zones at most
    their skew (1), and cnt_final equal to cnt0 plus the counts recomputed
    from the placements. Returns the per-zone spread counts."""
    from yunikorn_tpu_torch.client.synthetic import LOCALITY_APPS

    kinds = {f"app-{k}": c
             for k, (_cpu, _mem, c, _share) in enumerate(LOCALITY_APPS)}
    a = res.assigned[:len(pods)].cpu().numpy()
    anti_nodes, spread_zone = [], {}
    for pod, row in zip(pods, a):
        if row < 0:
            continue
        kind = kinds[pod.metadata.labels["applicationId"]]
        node = enc.nodes.name_of(int(row))
        if kind == "host-anti":
            anti_nodes.append(node)
        elif kind == "zone-spread":
            zone = enc.cache.get_node(node).node.metadata.labels["zone"]
            spread_zone[zone] = spread_zone.get(zone, 0) + 1
    if len(set(anti_nodes)) != len(anti_nodes):
        raise AssertionError("two anti-affinity pods share a node")
    zones = {n.metadata.labels["zone"] for n in
             (enc.cache.get_node(name).node
              for name in enc.nodes._name_to_idx)}
    per_zone = [spread_zone.get(z, 0) for z in sorted(zones)]
    if max(per_zone) - min(per_zone) > 1:
        raise AssertionError(f"hard spread skew above 1: {per_zone}")
    lb = batch.locality
    cnt = lb.cnt0.astype(np.int64)
    full = np.full(lb.contrib.shape[0], -1)
    full[:len(a)] = a
    for l in range(cnt.shape[0]):
        rows = np.nonzero((full >= 0) & lb.contrib[:, l])[0]
        doms = lb.dom[l, full[rows]]
        np.add.at(cnt[l], doms[doms >= 0], 1)
    if not np.array_equal(cnt, res.cnt_final.cpu().numpy()):
        raise AssertionError("cnt_final differs from the counts of the "
                             "placements")
    return {"anti_pods_placed": len(anti_nodes),
            "spread_per_zone": dict(zip(sorted(zones), per_zone))}


def phase_locality(dev, stats, clock_hz):
    """The locality mix: the cut (cuda against cpu, solve and core), then
    the full width (10,000 nodes x 50,000 pods) through solve_batch on
    `cuda`, with best_nodes' launches read around that one run."""
    from yunikorn_tpu_torch.client.synthetic import make_locality_pods
    from yunikorn_tpu_torch.ops import assign, best_nodes as bn_mod
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    cut = locality_cut(dev)
    enc, batch, pods, encode_ms = build_workload(MAIN_NODES, MAIN_PODS,
                                                 make_locality_pods)
    res, captured, launches, first_ms = solve_capturing(batch, enc, dev)
    placed = int((res.assigned[:len(pods)] >= 0).sum())
    if launches < 1:
        raise AssertionError("the locality path launched no best_nodes "
                             "kernel")
    expected = EXPECTED_LOCALITY[(MAIN_NODES, MAIN_PODS)]
    if (res.rounds, placed) != expected:
        raise AssertionError(f"rounds/placed {(res.rounds, placed)} != "
                             f"{expected}")
    check_placements(batch, enc, res, len(pods), dev)
    rules = check_locality(batch, enc, res, pods, dev)

    # the kernel at one locality round's inputs (its feasibility and soft
    # matrices carry that round's rules and scores): bit-equal to plain
    args, kwargs = captured[-1]
    got = best_nodes(*args, **kwargs)
    ref = bn_mod.best_nodes_reference(*args, **kwargs)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("kernel differs from plain at a locality "
                             "round's inputs")
    solve_ms = warm_solve_ms(batch, enc, dev)
    profile = profile_solve(
        lambda: assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW))
    calls = odd_round_calls(captured, clock_hz)
    stats.setdefault("best_nodes", {})["launches_locality"] = launches
    accepted = res.accept_round[res.accept_round >= 0].long()
    return {"cut": cut, "nodes": MAIN_NODES, "pods": MAIN_PODS,
            "N": int(batch.req.shape[0]), "M": enc.nodes.capacity,
            "G": int(batch.g_tol.shape[0]),
            "L": int(batch.locality.dom.shape[0]),
            "D": int(batch.locality.cnt0.shape[1]),
            "locality_groups": batch.locality.num_groups,
            "has_loc_soft": bool(np.any(batch.locality.g_weight)),
            "rounds": res.rounds, "placed": placed,
            "expected": list(expected),
            "placed_per_round": torch.bincount(
                accepted, minlength=res.rounds).tolist(),
            "rules": rules, "best_nodes_launches": launches,
            "kernel_equal_at_locality_round": True,
            "encode_ms": encode_ms, "first_solve_ms": first_ms,
            "warm_solve_ms_median": statistics.median(solve_ms),
            "warm_solve_ms": solve_ms, "profile": profile,
            "kernel_calls": calls,
            "kernel_ms_per_solve": sum(c["ms"] for c in calls),
            "bound_ms_per_solve": sum(c["bound_ms"] for c in calls)}


def topology_workload(n_pods, n_nodes, n_domains):
    """client/synthetic's topology fleet (n_nodes in n_domains ICI domains,
    co-tenants on about 60% of them) and its gang wave, encoded: (encoder,
    batch, asks, gangs, co-tenant pods, host encode ms)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_gang_pods,
                                                     make_topology_fleet)
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    nodes, co_tenants = make_topology_fleet(n_nodes, n_domains)
    for node in nodes:
        cache.update_node(node)
    for pod in co_tenants:
        cache.update_pod(pod)
    pods, gangs = make_gang_pods(n_pods, n_nodes)
    asks = asks_of(pods)
    enc = SnapshotEncoder(cache)
    t0 = time.perf_counter()
    enc.sync_nodes(full=True)
    batch = enc.build_batch(asks)
    encode_ms = (time.perf_counter() - t0) * 1e3
    return enc, batch, asks, gangs, co_tenants, encode_ms


def fold_topology(batch, asks, enc):
    """Fold the steering args onto the batch (app_rows={}: no app holds
    allocations yet), as scripts/topology_bench.py does: host ms."""
    from yunikorn_tpu_torch.topology.score import build_topo_args

    t0 = time.perf_counter()
    batch.topo = build_topo_args(asks, batch, enc.nodes, app_rows={})
    ms = (time.perf_counter() - t0) * 1e3
    if batch.topo is None or not batch.topo.stats.get("gangs"):
        raise AssertionError("steering did not engage: no gang planned")
    return ms


def one_domain_ratio(assigned, asks, gangs, na) -> float:
    """The share of gangs whose every member landed inside one ICI domain
    (an unplaced member splits its gang), scripts/topology_bench.py's
    metric."""
    doms = {}
    for i, row in enumerate(assigned[:len(asks)].cpu().tolist()):
        doms.setdefault(asks[i].application_id, set()).add(
            int(na.topo[row, 2]) if row >= 0 else -2)
    whole = sum(1 for app, _ in gangs
                if len(doms.get(app, {-2})) == 1 and -2 not in doms[app])
    return whole / max(len(gangs), 1)


def topology_result(batch, asks, gangs, enc, res):
    placed = int((res.assigned[:len(asks)] >= 0).sum())
    return {"rounds": res.rounds, "placed": placed,
            "one_domain_ratio": one_domain_ratio(res.assigned, asks, gangs,
                                                 enc.nodes)}


def check_expected_topology(shape, got, steered=True):
    want = EXPECTED_TOPOLOGY[shape]["on" if steered else "off"]
    if got != want:
        raise AssertionError(f"{'steered' if steered else 'un-steered'} "
                             f"{shape}: {got} != the JAX package's {want}")


TOPO_METRICS = ("topology_gangs_total", "topology_cross_domain_gangs_total",
                "topology_domain_fragmentation")


def topology_cut(dev):
    """At the cut: the steered solve_batch on `cuda` and on `cpu`
    bit-identical in all five outputs and equal to the JAX package's, then
    one core cycle (solver.topology auto on the labelled fleet) on each,
    binding identically by pod name with equal topology metrics, the JAX
    core's placed count and metrics."""
    from yunikorn_tpu_torch.ops.assign import solve_batch

    shape = (TOPO_CUT_PODS, TOPO_CUT_NODES, TOPO_CUT_DOMAINS)
    enc, batch, asks, gangs, co_tenants, _ = topology_workload(*shape)
    fold_topology(batch, asks, enc)
    on_card = solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
    torch.cuda.synchronize()
    on_cpu = solve_batch(batch, enc.nodes, device="cpu", **SOLVE_KW)
    same = {f: bool(torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)))
            for f in ("assigned", "accept_round", "free_after")}
    # no locality in this wave: both solves return no domain counts
    same["cnt_final"] = on_card.cnt_final is None and on_cpu.cnt_final is None
    same["rounds"] = on_card.rounds == on_cpu.rounds
    if not all(same.values()):
        raise AssertionError(f"cuda and cpu steered solves differ: {same}")
    got = topology_result(batch, asks, gangs, enc, on_card)
    check_expected_topology(shape, got)

    from yunikorn_tpu_torch.client.synthetic import (make_gang_pods,
                                                     make_topology_fleet)

    out, binds, metrics = {}, {}, {}
    for label, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        nodes, co_tenants = make_topology_fleet(TOPO_CUT_NODES,
                                                TOPO_CUT_DOMAINS)
        pods, _ = make_gang_pods(TOPO_CUT_PODS, TOPO_CUT_NODES)
        apps = sorted({p.metadata.labels["applicationId"] for p in pods})
        cache, core, cb = make_core(device, nodes,
                                    [(a, "root.gangs") for a in apps])
        for pod in co_tenants:
            cache.update_pod(pod)
        names = {p.uid: p.metadata.name for p in pods}
        n, cycle_s = core_cycle(core, asks_of(pods))
        check_tiers(core, f"topology cut on {label}")
        if not core._topology_active:
            raise AssertionError(f"{label}: topology did not engage")
        binds[label] = {names[k]: v for k, v in cb.bound.items()}
        m = core.metrics
        metrics[label] = {
            **{k: m.get(k) for k in TOPO_METRICS},
            **{k: v for k, v in m["last_cycle"]["default"].items()
               if k.startswith("topo_")}}
        out[label] = {"placed": n, "cycle_ms": cycle_s * 1e3}
    if binds["cuda"] != binds["cpu"]:
        diff = sum(binds["cuda"].get(k) != v for k, v in binds["cpu"].items())
        raise AssertionError(f"cuda and cpu cores bind the gang wave "
                             f"differently ({diff} pods)")
    if metrics["cuda"] != metrics["cpu"]:
        raise AssertionError(f"topology metrics differ: {metrics}")
    if not metrics["cuda"].get("topo_gangs"):
        raise AssertionError("the core's cycle planned no gang")
    if (out["cuda"]["placed"], metrics["cuda"]) != EXPECTED_TOPOLOGY_CORE_CUT:
        raise AssertionError(f"core placed {out['cuda']['placed']}, metrics "
                             f"{metrics['cuda']} != the JAX core's "
                             f"{EXPECTED_TOPOLOGY_CORE_CUT}")
    return {"shape": list(shape), "solve_identical": same, **got,
            "core_identical": True, "core": out,
            "core_metrics": metrics["cuda"]}


def phase_topology(dev, stats, clock_hz):
    """Topology steering: the cut (cuda against cpu, solve and core), then
    the gang wave at 10,240 nodes in 320 ICI domains x 7,680 asks through
    solve_batch on `cuda` with the steering folded on, best_nodes' launches
    read around that one run."""
    from yunikorn_tpu_torch.ops import assign, best_nodes as bn_mod
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    cut = topology_cut(dev)
    shape = (TOPO_PODS, TOPO_NODES, TOPO_DOMAINS)
    enc, batch, asks, gangs, _, encode_ms = topology_workload(*shape)

    # the un-steered solve of the same wave, beside it
    batch.topo = None
    off = topology_result(batch, asks, gangs, enc,
                          assign.solve_batch(batch, enc.nodes, device=dev,
                                             **SOLVE_KW))
    check_expected_topology(shape, off, steered=False)
    off_ms = warm_solve_ms(batch, enc, dev, runs=3)

    fold_ms = fold_topology(batch, asks, enc)
    topo = batch.topo
    res, captured, launches, first_ms = solve_capturing(batch, enc, dev)
    if launches < 1:
        raise AssertionError("the topology path launched no best_nodes "
                             "kernel")
    if not all(kw.get("pref") is not None for _, kw in captured):
        raise AssertionError("a steered round called best_nodes without "
                             "the planned-domain bonus")
    got = topology_result(batch, asks, gangs, enc, res)
    check_expected_topology(shape, got)
    check_placements(batch, enc, res, len(asks), dev)

    # the kernel at a steered round's inputs: bit-equal to plain
    args, kwargs = captured[-1]
    k_got = best_nodes(*args, **kwargs)
    k_ref = bn_mod.best_nodes_reference(*args, **kwargs)
    if not (torch.equal(k_got[0], k_ref[0]) and torch.equal(k_got[1], k_ref[1])):
        raise AssertionError("kernel differs from plain at a steered round's "
                             "inputs")
    plain_ms = cuda_ms(lambda: bn_mod.best_nodes_reference(*args, **kwargs), 3)
    solve_ms = warm_solve_ms(batch, enc, dev, runs=3)
    fold_again = [fold_topology(batch, asks, enc) for _ in range(3)]
    profile = profile_solve(
        lambda: assign.solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW))
    calls = odd_round_calls(captured, clock_hz)
    stats.setdefault("best_nodes", {})["launches_topology"] = launches
    accepted = res.accept_round[res.accept_round >= 0].long()
    return {"cut": cut, "shape": list(shape),
            "N": int(batch.req.shape[0]), "M": enc.nodes.capacity,
            "D": int(topo.dom_busy.shape[0]),
            "G": int(batch.g_tol.shape[0]), "gangs": len(gangs),
            "gangs_planned": topo.stats["gangs"],
            "domains": topo.stats["domains"],
            "fragmentation": topo.stats["fragmentation"],
            **got, "expected": EXPECTED_TOPOLOGY[shape],
            "unsteered": off,
            "unsteered_warm_solve_ms_median": statistics.median(off_ms),
            "unsteered_warm_solve_ms": off_ms,
            "placed_per_round": torch.bincount(
                accepted, minlength=res.rounds).tolist(),
            "best_nodes_launches": launches,
            "kernel_equal_at_steered_round": True,
            "encode_ms": encode_ms, "fold_ms": fold_ms,
            "fold_ms_warm": fold_again, "first_solve_ms": first_ms,
            "warm_solve_ms_median": statistics.median(solve_ms),
            "warm_solve_ms": solve_ms, "profile": profile,
            "kernel_calls": calls,
            "kernel_ms_per_solve": sum(c["ms"] for c in calls),
            "bound_ms_per_solve": sum(c["bound_ms"] for c in calls),
            "plain_ms_at_last_steered_round": plain_ms}


def preempt_cluster(seed, n_nodes, n_asks):
    """tests/test_preempt_solve.py's build_cluster at n_nodes with n_asks
    asks: nodes of 4,000m / 8 GiB holding 0-6 bound victims each at mixed
    priorities and sizes, and high-priority asks (priority 10, 50 or 100)
    that fit nowhere without evictions. (cache, encoder, asks,
    app_of_pod)."""
    import random

    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.common.objects import make_node, make_pod
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    rng = random.Random(seed)
    cache = SchedulerCache()
    app_of_pod = {}
    for i in range(n_nodes):
        cache.update_node(make_node(f"n{i:05d}", cpu_milli=4000,
                                    memory=8 * 2**30,
                                    labels={"zone": f"z{i % 3}"}))
        for j in range(rng.randint(0, 6)):
            v = make_pod(f"v-{i}-{j}",
                         cpu_milli=rng.choice([250, 500, 1000, 1500]),
                         memory=rng.choice([2**28, 2**29]),
                         node_name=f"n{i:05d}", phase="Running",
                         priority=rng.choice([0, 1, 1, 2, 5]))
            v.metadata.creation_timestamp = 1000.0 + rng.random() * 100
            cache.update_pod(v)
            app_of_pod[v.uid] = f"victim-app-{i % 4}"
    asks = []
    for k in range(n_asks):
        p = make_pod(f"hi-{seed}-{k}",
                     cpu_milli=rng.choice([1000, 2000, 3000]),
                     memory=2**28, priority=rng.choice([10, 50, 100]))
        cache.update_pod(p)
        asks.append(AllocationAsk(p.uid, f"hi-app-{k % 2}",
                                  get_pod_resource(p),
                                  priority=p.spec.priority, pod=p))
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return cache, enc, asks, app_of_pod


def plans_key(plans):
    return [(p.ask.pod.metadata.name, p.node_id,
             [v.metadata.name for v in p.victims]) for p in plans]


def quota_held_trace(device):
    """tests/test_preempt_solve.py's run_quota_held_trace on the port's core
    (device planner at its default, on): four nodes each filled by one
    priority-0 victim, six priority-100 asks of which the queue's 3-vcore
    quota holds all but one, the leftover preempting. The quota is set on
    the queue tree directly (the queues.yaml parser needs PyYAML). (evicted
    pod names in emit order, held count, core)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.common import si
    from yunikorn_tpu_torch.common.objects import make_node, make_pod
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.core import queues
    from yunikorn_tpu_torch.core.scheduler import CoreScheduler, SolverOptions

    cache = SchedulerCache()
    names, released, victims = {}, [], []
    for i in range(4):
        cache.update_node(make_node(f"qn{i}", cpu_milli=2000,
                                    memory=8 * 2**30))
        v = make_pod(f"qv-{i}", cpu_milli=2000, memory=2**28,
                     node_name=f"qn{i}", phase="Running", priority=0)
        v.metadata.creation_timestamp = 1000.0 + i
        cache.update_pod(v)
        victims.append(v)
        names[v.uid] = v.metadata.name

    class Callback(NullCallback):
        def update_allocation(self, response):
            for rel in response.released:
                if (rel.termination_type
                        == si.TerminationType.PREEMPTED_BY_SCHEDULER):
                    released.append(names[rel.allocation_key])

    core = CoreScheduler(cache, device=device,
                         solver_options=SolverOptions(pipeline=False))
    core.register_resource_manager(si.RegisterResourceManagerRequest(
        rm_id="t", policy_group="queues"), Callback())
    core.queue_trees["default"].reload(queues._parse_queue_config(
        {"name": "root", "queues": [
            {"name": "qv"},
            {"name": "qhi", "resources": {"max": {"vcore": 3}}}]}))
    core.update_application(si.ApplicationRequest(new=[
        si.AddApplicationRequest(application_id="victim-app",
                                 queue_name="root.qv",
                                 user=si.UserGroupInfo(user="v")),
        si.AddApplicationRequest(application_id="hi-app",
                                 queue_name="root.qhi",
                                 user=si.UserGroupInfo(user="h"))]))
    core.update_node(si.NodeRequest(nodes=[si.NodeInfo(
        node_id=f"qn{i}", action=si.NodeAction.CREATE,
        existing_allocations=[si.Allocation(
            allocation_key=v.uid, application_id="victim-app",
            node_id=f"qn{i}", resource=get_pod_resource(v))])
        for i, v in enumerate(victims)]))
    asks = []
    for k in range(6):
        p = make_pod(f"qhi-{k}", cpu_milli=2000, memory=2**28, priority=100)
        p.metadata.creation_timestamp = 2000.0 + k
        cache.update_pod(p)
        asks.append(si.AllocationAsk(p.uid, "hi-app", get_pod_resource(p),
                                     priority=100, pod=p))
    core.update_allocation(si.AllocationRequest(asks=asks))
    core.schedule_once()
    held = core.obs.get("unschedulable_total").value(reason="quota_held")
    return released, held, core


def phase_preempt(dev):
    """The device preemption planner: 32 asks against 10,000 nodes of
    victims on `cuda`, plan for plan equal to the host planner and to the
    JAX package's plan count, dispatch and finish timed; then the
    quota-held trace through the port's core on `cuda` and on `cpu`."""
    from yunikorn_tpu_torch.core.preemption import (dispatch_preemption_solve,
                                                    finish_preemption_solve,
                                                    plan_preemptions)

    cache, enc, asks, app_of_pod = preempt_cluster(0, PREEMPT_NODES,
                                                   PREEMPT_ASKS)
    cands = list(cache.node_names())
    runs = []
    for _ in range(3):   # the first run also syncs the victim tables
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = dispatch_preemption_solve(cache, enc, asks, app_of_pod,
                                           candidate_nodes=cands, device=dev)
        t1 = time.perf_counter()
        plans, attempted, pstats = finish_preemption_solve(handle)
        t2 = time.perf_counter()
        runs.append({"dispatch_ms": (t1 - t0) * 1e3,
                     "finish_ms": (t2 - t1) * 1e3,
                     "victim_nodes_synced": pstats["victim_nodes_synced"],
                     **{k: pstats.get(k) for k in (
                         "victim_refresh", "node_refresh",
                         "mirror_upload_bytes")}})
    mirror_runs = [(r["victim_refresh"], r["node_refresh"]) for r in runs]
    if mirror_runs != [("full", "full"), ("clean", "clean"),
                       ("clean", "clean")]:
        raise AssertionError(f"victim/node mirror refreshes {mirror_runs}, "
                             "expected full then clean")
    host, host_attempted = plan_preemptions(cache, asks, app_of_pod,
                                            candidate_nodes=cands)
    if plans_key(plans) != plans_key(host) or attempted != host_attempted:
        raise AssertionError("device plans differ from the host planner's")
    if {p.planner for p in plans} != {"device"} or pstats["fallbacks"]:
        raise AssertionError(f"not every plan came from the device: "
                             f"{pstats}")
    victims = sum(len(p.victims) for p in plans)
    if ((len(plans), victims) != EXPECTED_PREEMPT
            or [tuple(k) for k in plans_key(plans)[:3]]
            != EXPECTED_PREEMPT_FIRST):
        raise AssertionError(f"(plans, victims) {(len(plans), victims)}, "
                             f"first plans {plans_key(plans)[:3]} != the JAX "
                             f"package's {EXPECTED_PREEMPT}, "
                             f"{EXPECTED_PREEMPT_FIRST}")
    def dispatch_and_finish():
        return finish_preemption_solve(dispatch_preemption_solve(
            cache, enc, asks, app_of_pod, candidate_nodes=cands, device=dev))

    profile = profile_solve(dispatch_and_finish, top=8)
    # the same dispatch right after the mirror is discarded: node fields and
    # victim tables upload in full, as every dispatch did without a mirror
    enc.discard_device_mirror()
    profile_full = profile_solve(dispatch_and_finish, top=8)
    if enc.device.last_victim_refresh != "full":
        raise AssertionError("after a discard the victim mirror refreshed "
                             f"{enc.device.last_victim_refresh}")

    trace = {}
    for label, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        released, held, core = quota_held_trace(device)
        if (released, held) != EXPECTED_QUOTA_HELD:
            raise AssertionError(f"{label}: evicted {released}, held {held} "
                                 f"!= the JAX core's {EXPECTED_QUOTA_HELD}")
        plans_m = core.metrics.get("preemption_plans_total")
        if plans_m != {"planner=device": len(released)}:
            raise AssertionError(f"{label}: plans {plans_m}")
        trace[label] = {"evicted": released, "held": held, "plans": plans_m}
    na = enc.nodes
    return {"nodes": PREEMPT_NODES, "asks": PREEMPT_ASKS,
            "victim_tables": list(na.victim_req.shape),
            "plans": len(plans), "victims": victims,
            "expected": list(EXPECTED_PREEMPT), "equal_to_host": True,
            "runs": runs, "profile": profile,
            "profile_after_discard": profile_full,
            "htod_ms": {"mirror_clean": profile.get("htod_ms"),
                        "mirror_after_discard": profile_full.get("htod_ms")},
            "quota_held": trace}


def gate_problem(n_asks, scale):
    """gate_bench's backlog (client/synthetic's copy of its build) at
    n_asks in one contention shape, extracted: (problem, by_queue, meta,
    tree)."""
    from yunikorn_tpu_torch.client.synthetic import (build_gate_trace,
                                                     build_gate_tree,
                                                     gate_meta_for)
    from yunikorn_tpu_torch.core.gate import extract_problem

    tree = build_gate_tree(n_asks, scale=scale)
    by_queue = build_gate_trace(tree, n_asks)
    meta = gate_meta_for(tree, by_queue)
    return extract_problem(by_queue, meta, tree), by_queue, meta, tree


def gate_shape(dev, shape, scale, runs=3):
    """One contention shape at GATE_ASKS: device_admit on the card equal
    to host_scan (admitted order, held count) within the pass bound, and
    both gates' admit ms (host clock around the call, extraction excluded),
    the device scan's device_ms and passes, medians of `runs` after one
    warm-up of each."""
    from yunikorn_tpu_torch.core.gate import host_scan
    from yunikorn_tpu_torch.ops.gate_solve import device_admit

    def timed(fn):
        problem = gate_problem(GATE_ASKS, scale)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(problem)
        return out, (time.perf_counter() - t0) * 1e3

    timed(lambda p: device_admit(p, device=dev))
    timed(host_scan)
    dev_runs, host_runs = [], []
    for _ in range(runs):
        dev_runs.append(timed(lambda p: device_admit(p, device=dev)))
        host_runs.append(timed(host_scan))
    (d_adm, d_held, d_stats), _ = dev_runs[-1]
    (h_adm, h_held, h_stats), _ = host_runs[-1]
    if ([a.allocation_key for a in d_adm] != [a.allocation_key for a in h_adm]
            or d_held != h_held):
        raise AssertionError(f"{shape}: the device gate admitted "
                             f"{len(d_adm)} / held {d_held}, the host scan "
                             f"{len(h_adm)} / {h_held}")
    if d_stats["passes"] > d_stats["max_passes"]:
        raise AssertionError(f"{shape}: {d_stats['passes']} passes past the "
                             f"bound {d_stats['max_passes']}")
    med = lambda xs: statistics.median(xs)  # noqa: E731
    problem = gate_problem(GATE_ASKS, scale)[0]
    profile = profile_solve(lambda: device_admit(problem, device=dev), top=8)
    return {"asks": GATE_ASKS, "scale": scale, "admitted": len(d_adm),
            "held": d_held, "held_share": d_held / GATE_ASKS,
            "trackers": d_stats["trackers"],
            "device": {"passes": d_stats["passes"],
                       "max_passes": d_stats["max_passes"],
                       "finish_loop": d_stats["finish_loop"],
                       "call_ms": med([ms for _, ms in dev_runs]),
                       "admit_ms": med([o[2]["admit_ms"] for o, _ in dev_runs]),
                       "device_ms": med([o[2]["device_ms"]
                                         for o, _ in dev_runs]),
                       "transfer_bytes": d_stats["transfer_bytes"]},
            "host": {"passes": h_stats.get("passes"),
                     "call_ms": med([ms for _, ms in host_runs]),
                     "admit_ms": med([o[2]["admit_ms"]
                                      for o, _ in host_runs])},
            "device_profile": profile}


def gate_core_cycle(device, gate_device=None):
    """One quota-bound cycle of the port's core: GATE_CORE_ASKS sleep pods
    (gate_bench's requests: 100/250/500m cpu, 128/512 bytes of memory) on
    the contended tree (gate_queue_config, scale 1.0) over 1,000 kwok nodes,
    from three users' apps on every leaf. The queue config is set on the
    tree directly (the queues.yaml parser needs PyYAML). (bindings by pod
    name, held count, last cycle entry)."""
    import random

    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (GATE_USERS,
                                                     gate_queue_config,
                                                     make_kwok_nodes)
    from yunikorn_tpu_torch.common import si
    from yunikorn_tpu_torch.common.objects import make_pod
    from yunikorn_tpu_torch.core.scheduler import CoreScheduler, SolverOptions

    cache = SchedulerCache()
    core = CoreScheduler(cache, device=device, solver_options=SolverOptions(
        gate_device=gate_device, pipeline=False))
    cb = NullCallback()
    core.register_resource_manager(si.RegisterResourceManagerRequest(
        rm_id="gate", policy_group="queues"), cb)
    core.queue_trees["default"].reload(gate_queue_config(GATE_CORE_ASKS,
                                                         scale=1.0))
    nodes = make_kwok_nodes(1_000)
    for n in nodes:
        cache.update_node(n)
    core.update_node(si.NodeRequest(nodes=[
        si.NodeInfo(node_id=n.name, action=si.NodeAction.CREATE)
        for n in nodes]))
    leaves = [q.full_name for q in core.queue_trees["default"].leaves()]
    apps = []
    for leaf in leaves:
        for user, groups in GATE_USERS:
            app_id = f"{leaf}-{user}"
            core.update_application(si.ApplicationRequest(new=[
                si.AddApplicationRequest(
                    application_id=app_id, queue_name=leaf,
                    user=si.UserGroupInfo(user=user, groups=list(groups)))]))
            apps.append(app_id)
    rng = random.Random(42)
    pods = [make_pod(f"g-{i}", cpu_milli=rng.choice([100, 250, 500]),
                     memory=rng.choice([128, 512]),
                     labels={"applicationId": apps[i % len(apps)]})
            for i in range(GATE_CORE_ASKS)]
    names = {p.uid: p.metadata.name for p in pods}
    n, cycle_s = core_cycle(core, asks_of(pods))
    check_tiers(core, f"quota-bound cycle on {device}")
    held = core.obs.get("unschedulable_total").value(reason="quota_held")
    return ({names[k]: v for k, v in cb.bound.items()}, held,
            dict(cycle_split(core), cycle_ms=cycle_s * 1e3,
                 gate_path_total=core.metrics.get("gate_path_total")))


def phase_gate(dev):
    """The admission gate: gate_bench's backlog at 50,000 asks in the
    default, contended and saturated shapes through device_admit on the
    card and host_scan, then one quota-bound core cycle on the card with
    gateDevice auto binding as one with gateDevice=False and one on the
    CPU."""
    from yunikorn_tpu_torch.client.synthetic import GATE_SHAPES

    shapes = {shape: gate_shape(dev, shape, scale)
              for shape, scale in GATE_SHAPES.items()}
    cores = {}
    binds = {}
    for label, device, gd in (("cuda_auto", dev, None),
                              ("cuda_gate_device_false", dev, False),
                              ("cpu_auto", torch.device("cpu"), None)):
        binds[label], held, cores[label] = gate_core_cycle(device, gd)
        cores[label]["held"] = held
    paths = {k: c["gate_path"] for k, c in cores.items()}
    if paths != {"cuda_auto": "device", "cuda_gate_device_false": "vector",
                 "cpu_auto": "device"}:
        raise AssertionError(f"gate paths {paths}")
    if not (binds["cuda_auto"] == binds["cuda_gate_device_false"]
            == binds["cpu_auto"]):
        raise AssertionError("the quota-bound cycle binds differently with "
                             "the device gate, the host gate and on the CPU")
    if not cores["cuda_auto"]["held"]:
        raise AssertionError("the quota-bound cycle held nothing")
    return {"shapes": shapes,
            "core": {"asks": GATE_CORE_ASKS,
                     "bound": len(binds["cuda_auto"]),
                     "identical": True, **cores}}


# --------------------------------------------------------------------------
# the duel arms (solver.policy=optimal)
# --------------------------------------------------------------------------

def duel_fleet(n_pods, n_nodes, gang=0):
    """scripts/pack_bench.py's (gang 0) or cvx_bench.py's build through the
    port: (encoder, batch, priorities)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_pack_nodes,
                                                     make_pack_pods, pack_asks)
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    for node in make_pack_nodes(n_nodes):
        cache.update_node(node)
    asks, prio, ranks = pack_asks(make_pack_pods(n_pods),
                                  app_id="cvx-app" if gang > 1 else "pack-app",
                                  gang=gang)
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return enc, enc.build_batch(asks, ranks=ranks), prio


def warm_median_ms(fn, runs=5):
    """(median host ms of fn() over `runs` synchronised runs after one
    warm-up, the last result)."""
    out = fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def duel_prng(dev):
    """The random streams on the card against the CPU's: keys, split,
    fold_in, random bits and permutation(65,536) bit for bit; a Gumbel
    draw over [16, 4,096, 1,024] (the pack arm's per-round noise at full
    width) with its first and last parts held against the CPU's within
    1e-6 (the CPU would take most of a minute for all sixteen)."""
    from yunikorn_tpu_torch.utils import prng

    cpu = torch.device("cpu")
    for seed in (0, DUEL_SEED, 2**31 - 1):
        kc, kd = prng.prng_key(seed, cpu), prng.prng_key(seed, dev)
        pairs = [(prng.split(kc, 16), prng.split(kd, 16)),
                 (prng.fold_in(kc, 5), prng.fold_in(kd, 5)),
                 (prng.random_bits(kc, (4_096, 1_024)),
                  prng.random_bits(kd, (4_096, 1_024))),
                 (prng.uniform(kc, (1_024, 1_024)),
                  prng.uniform(kd, (1_024, 1_024))),
                 (prng.permutation(kc, 65_536), prng.permutation(kd, 65_536))]
        for k, (c, d) in enumerate(pairs):
            if not torch.equal(c, d.cpu()):
                raise AssertionError(f"seed {seed}: stream {k} differs "
                                     "between the card and the CPU")
    k, n, m = DUEL_NOISE_SHAPE
    keys = prng.fold_in(prng.split(prng.prng_key(DUEL_SEED, dev), k), 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    noise = prng.gumbel(keys, (n, m))
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    gumbel_ms = cuda_ms(lambda: prng.gumbel(keys, (n, m)), 3)
    parts = [0, k - 1]
    ref = prng.gumbel(keys[parts].cpu(), (n, m))
    err = float((noise[parts].cpu() - ref).abs().max())
    if err > 1e-6 or not bool(torch.isfinite(noise).all()):
        raise AssertionError(f"Gumbel noise off the CPU's by {err}")
    return {"exact": ["split", "fold_in", "random_bits", "uniform",
                      "permutation(65536)"],
            "gumbel_shape": list(noise.shape), "gumbel_max_abs_err": err,
            "gumbel_ms": gumbel_ms, "gumbel_first_call_ms": first_ms}


def duel_shape(dev, n_pods, n_nodes, gang, expected, arms):
    """One bench shape on the card: greedy and the arms, warm ms, the
    duel, every plan feasible, each arm's (placed, units_norm) against the
    JAX package's."""
    from yunikorn_tpu_torch.ops import cvx_solve, pack_solve
    from yunikorn_tpu_torch.ops.assign import solve_batch

    enc, batch, prio = duel_fleet(n_pods, n_nodes, gang)
    n = batch.num_pods
    runs = {"greedy": lambda: solve_batch(batch, enc.nodes, device=dev,
                                          **SOLVE_KW),
            "optimal": lambda: pack_solve.pack_solve_batch(
                batch, enc.nodes, seed=DUEL_SEED, device=dev),
            "cvx": lambda: cvx_solve.cvx_solve_batch(
                batch, enc.nodes, seed=DUEL_SEED, device=dev)}
    ms, plans, extra = {}, [], {}
    for arm in ("greedy",) + arms:
        ms[arm], res = warm_median_ms(runs[arm])
        if int(res.free_after.min()) < 0:
            raise AssertionError(f"{arm} over-committed a node")
        if arm != "greedy" and not bool(res.feasible):
            raise AssertionError(f"{arm} returned an infeasible plan")
        if arm == "optimal":
            extra["parts"] = res.n_parts
        plans.append((arm, res.assigned[:n].cpu().numpy()))
    winner, st = pack_solve.choose_plan_n(
        plans, batch.req.astype(np.int32), batch.valid,
        cap_i=np.floor(enc.nodes.capacity_arr).astype(np.int64),
        priorities=np.asarray(prio))
    want_winner, want = expected
    got = {arm: (st[arm]["placed"], st[arm]["units_norm"]) for arm, _ in plans}
    if (got["greedy"][0] != want["greedy"][0]
            or abs(got["greedy"][1] - want["greedy"][1])
            > 1e-9 * want["greedy"][1]):
        raise AssertionError(f"greedy {got['greedy']} != the JAX package's "
                             f"{want['greedy']}")
    for arm in arms:
        if abs(got[arm][1] - want[arm][1]) > DUEL_UNITS_RTOL * want[arm][1]:
            raise AssertionError(f"{arm} units {got[arm]} off the JAX "
                                 f"package's {want[arm]}")
    return {"pods": n_pods, "nodes": n_nodes, "gang": gang, "winner": winner,
            "expected_winner": want_winner, "placed_units": got,
            "expected": want, "warm_ms": ms,
            "util_ratio": {arm: got[arm][1] / got["greedy"][1]
                           for arm in arms}, **extra}


def duel_core_full(dev):
    """solver.policy=optimal through the core at full width: the pressure
    mix, 10,000 nodes x 50,000 pods (N 65,536, M 16,384: 16 parts of
    4,096 x 1,024, the random partitioner, on the node mirror). A warm-up
    cycle and a release, then the measured cycle with best_nodes' launches
    counted from 0, split between the greedy solve's dispatch and the pack
    dispatch (the repair rounds)."""
    from yunikorn_tpu_torch.client.synthetic import (PRESSURE_APPS,
                                                     make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.core.scheduler import SolverOptions
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes
    from yunikorn_tpu_torch.ops.pack_solve import pick_parts

    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(PRESSURE_APPS))]
    cache, core, cb = make_core(dev, make_pressure_nodes(MAIN_NODES), apps,
                                SolverOptions(policy="optimal"))
    asks = asks_of(make_pressure_pods(MAIN_PODS))
    core_cycle(core, asks)
    release_all(core, asks)
    split = {"greedy": 0, "pack": 0}
    parts = []

    def counted(name, fn):
        def run(*a, **kw):
            before = best_nodes.launches
            try:
                return fn(*a, **kw)
            finally:
                split[name] += best_nodes.launches - before
        return run

    dispatch, pack = core._dispatch_solve, core._pack_dispatch

    def pack_spy(h):
        pack(h)
        parts.append((getattr(h.pack, "n_parts", None),
                      pick_parts(h.batch.req.shape[0],
                                 core.encoder.nodes.capacity)))

    core._dispatch_solve = counted("greedy", dispatch)
    core._pack_dispatch = counted("pack", pack_spy)
    try:
        best_nodes.launches = 0
        n, cycle_s = core_cycle(core, asks)
        launches = best_nodes.launches
    finally:
        core._dispatch_solve, core._pack_dispatch = dispatch, pack
    entry = dict(core.metrics["last_cycle"]["default"])
    outcomes = core.metrics.get("pack_plans_total") or {}
    check_tiers(core, "optimal core")
    if set(outcomes) - {"outcome=won", "outcome=fell_back"} or not outcomes:
        raise AssertionError(f"pack outcomes {outcomes}")
    if (entry.get("partitioner") != "random" or len(parts) != 1
            or parts[0][0] != parts[0][1]):
        raise AssertionError(f"partitioner {entry.get('partitioner')}, "
                             f"parts {parts}")
    if split["greedy"] < 1 or launches != split["greedy"] + split["pack"]:
        raise AssertionError(f"best_nodes launches {launches}: {split}")
    nodes_used = check_bindings(cache, cb.bound, asks)
    return {"nodes": MAIN_NODES, "pods": MAIN_PODS, "placed": n,
            "cycle_ms": cycle_s * 1e3, "split": cycle_split(core),
            "winner": entry.get("solver_policy"),
            "pack_util": entry.get("pack_util"),
            "pack_plan_ms": entry.get("pack_plan_ms"),
            "pack_placed": entry.get("pack_placed"),
            "greedy_placed": entry.get("greedy_placed"), "parts": parts[0][0],
            "pack_outcomes": outcomes, "best_nodes_launches": launches,
            "launches_greedy": split["greedy"],
            "launches_repair": split["pack"], "nodes_used": nodes_used,
            "oversubscribed": 0}


def duel_core_topology(dev):
    """The core on the labelled fleet (the topology cut, 1,024 nodes in 32
    ICI domains x 768 gang asks) with solver.policy=optimal: steering
    engages and the pack dispatch takes the ICI-domain partitioner."""
    from yunikorn_tpu_torch.client.synthetic import (make_gang_pods,
                                                     make_topology_fleet)
    from yunikorn_tpu_torch.core.scheduler import SolverOptions

    nodes, co_tenants = make_topology_fleet(TOPO_CUT_NODES, TOPO_CUT_DOMAINS)
    pods, _ = make_gang_pods(TOPO_CUT_PODS, TOPO_CUT_NODES)
    apps = sorted({p.metadata.labels["applicationId"] for p in pods})
    cache, core, cb = make_core(dev, nodes, [(a, "root.gangs") for a in apps],
                                SolverOptions(policy="optimal"))
    for pod in co_tenants:
        cache.update_pod(pod)
    asks = asks_of(pods)
    n, cycle_s = core_cycle(core, asks)
    check_tiers(core, "optimal topology core")
    entry = core.metrics["last_cycle"]["default"]
    modes = core.metrics.get("pack_partitioner_total")
    if not core._topology_active or modes != {"mode=topo": 1}:
        raise AssertionError(f"topology {core._topology_active}, "
                             f"partitioner {modes}")
    check_bindings(cache, cb.bound, asks)
    return {"placed": n, "cycle_ms": cycle_s * 1e3,
            "winner": entry.get("solver_policy"),
            "partitioner": entry.get("partitioner"),
            "pack_util": entry.get("pack_util"),
            "pack_plan_ms": entry.get("pack_plan_ms"),
            "pack_outcomes": core.metrics.get("pack_plans_total")}


def duel_core_cvx(dev):
    """solver.pack=cvx through the core at the pressure cut (2,000 x
    10,000: N 16,384 x M 2,048 = 2^25 cells, the cell budget's edge): the
    cvx arm runs and duels."""
    from yunikorn_tpu_torch.client.synthetic import (PRESSURE_APPS,
                                                     make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.core.scheduler import SolverOptions

    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(PRESSURE_APPS))]
    cache, core, cb = make_core(dev, make_pressure_nodes(CUT_NODES), apps,
                                SolverOptions(policy="optimal", pack="cvx"))
    asks = asks_of(make_pressure_pods(CUT_PODS))
    n, cycle_s = core_cycle(core, asks)
    check_tiers(core, "cvx core")
    entry = core.metrics["last_cycle"]["default"]
    outcomes = core.metrics.get("cvx_plans_total") or {}
    if set(outcomes) - {"outcome=won", "outcome=fell_back"} or not outcomes:
        raise AssertionError(f"cvx outcomes {outcomes}, skip "
                             f"{entry.get('cvx_skip')}")
    check_bindings(cache, cb.bound, asks)
    return {"nodes": CUT_NODES, "pods": CUT_PODS, "placed": n,
            "cycle_ms": cycle_s * 1e3, "split": cycle_split(core),
            "winner": entry.get("solver_policy"),
            "cvx_util": entry.get("cvx_util"),
            "cvx_solve_ms": entry.get("cvx_solve_ms"),
            "cvx_placed": entry.get("cvx_placed"),
            "cvx_outcomes": outcomes}


def duel_mock(dev, policy):
    """MockScheduler on `dev` with solver.policy=`policy`: the pack bench's
    smallest fleet and wave (1,024 pods, 128 nodes), every pod in the
    cluster before start; run until the bound count holds still for 2 s.
    (bound, pack outcomes, wall s)."""
    from yunikorn_tpu_torch.client.synthetic import (make_pack_nodes,
                                                     make_pack_pods)
    from yunikorn_tpu_torch.shim.mock_scheduler import MockScheduler

    ms = MockScheduler()
    ms.init(interval=0.05, core_interval=0.05,
            conf_extra={"log.level": "WARN", "solver.policy": policy},
            device=dev)
    try:
        for node in make_pack_nodes(DUEL_MOCK_NODES):
            ms.cluster.add_node(node)
        for pod in make_pack_pods(DUEL_MOCK_PODS):
            ms.cluster.add_pod(pod)
        stats = ms.bind_stats()
        t0 = time.perf_counter()
        ms.start()
        last, still = -1, time.perf_counter()
        while time.perf_counter() - t0 < 60:
            time.sleep(0.1)
            if stats.success_count != last:
                last, still = stats.success_count, time.perf_counter()
            elif time.perf_counter() - still > 2.0 and last > 0:
                break
        check_tiers(ms.core, f"mock {policy}")
        _, bound = check_fake_cluster(ms)
        return bound, ms.core.metrics.get("pack_plans_total") or {}, \
            time.perf_counter() - t0
    finally:
        ms.stop()


def duel_profiles(dev):
    """Device time by kernel of one warm pack solve at full width (the
    pressure mix's batch, 16 parts of 4,096 x 1,024) and one warm cvx
    solve at the cut (16,384 x 2,048), with the two stages named in
    advance as kernel candidates timed alone: the Gumbel draw of one
    rounding round and the row projection of one primal step."""
    from yunikorn_tpu_torch.ops import cvx_solve, pack_solve
    from yunikorn_tpu_torch.utils import prng

    out = {}
    enc, batch, _, _ = build_workload(MAIN_NODES, MAIN_PODS)
    pack = lambda: pack_solve.pack_solve_batch(  # noqa: E731
        batch, enc.nodes, seed=DUEL_SEED, device=dev)
    ms, res = warm_median_ms(pack, runs=3)
    keys = prng.fold_in(prng.split(prng.prng_key(DUEL_SEED, dev),
                                   res.n_parts), 0)
    n = batch.req.shape[0] // res.n_parts
    m = enc.nodes.capacity // res.n_parts
    gumbel = cuda_ms(lambda: prng.gumbel(keys, (n, m)), 3)
    prof = profile_solve(pack, top=12)
    out["pack_full"] = {"warm_ms": ms, "parts": res.n_parts,
                        "profile": prof, "gumbel_round_ms": gumbel,
                        "gumbel_share": (pack_solve.ROUND_ROUNDS * gumbel
                                         / prof["device_busy_ms"]
                                         if prof.get("device_busy_ms")
                                         else None)}
    enc, batch, _, _ = build_workload(CUT_NODES, CUT_PODS)
    cvx = lambda: cvx_solve.cvx_solve_batch(  # noqa: E731
        batch, enc.nodes, seed=DUEL_SEED, device=dev)
    ms, res = warm_median_ms(cvx, runs=3)
    N, M = batch.req.shape[0], enc.nodes.capacity
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((N, M), device=dev, generator=g)
    ok = (torch.rand((N, M), device=dev, generator=g) < 0.7).float()
    project = cuda_ms(lambda: cvx_solve._project_rows(x, ok), 3)
    prof = profile_solve(cvx, top=12)
    out["cvx_cut"] = {"warm_ms": ms, "shape": [N, M], "profile": prof,
                      "project_rows_step_ms": project,
                      "project_share": (cvx_solve.CVX_ITERS * project
                                        / prof["device_busy_ms"]
                                        if prof.get("device_busy_ms")
                                        else None)}
    return out


def phase_duel(dev, stats):
    """The pack and cvx duel arms: the random streams on the card, the
    bench shapes of both arms against the JAX package's plans, the core
    with solver.policy=optimal at full width (random partitioner), on the
    labelled fleet (ICI-domain partitioner) and with solver.pack=cvx at
    the cut, MockScheduler optimal against greedy, and each arm's device
    profile."""
    out = {"prng": duel_prng(dev)}
    out["pack"] = [duel_shape(dev, n, m, 0, EXPECTED_PACK[(n, m)],
                              ("optimal",)) for n, m in PACK_SHAPES]
    last = out["pack"][-1]
    if last["expected_winner"] == "optimal" and last["winner"] != "optimal":
        raise AssertionError(f"the card's pack plan lost the largest "
                             f"shape's duel: {last}")
    out["cvx"] = [duel_shape(dev, n, m, g, EXPECTED_CVX[(n, m, g)],
                             ("optimal", "cvx")) for n, m, g in CVX_SHAPES]
    out["core_full"] = duel_core_full(dev)
    stats.setdefault("best_nodes", {})["launches_duel"] = \
        out["core_full"]["best_nodes_launches"]
    stats["best_nodes"]["launches_duel_repair"] = \
        out["core_full"]["launches_repair"]
    out["core_topology"] = duel_core_topology(dev)
    out["core_cvx_cut"] = duel_core_cvx(dev)
    bound_opt, outcomes, wall = duel_mock(dev, "optimal")
    bound_greedy, _, _ = duel_mock(dev, "greedy")
    if (outcomes.get("outcome=won", 0) < 1
            or set(outcomes) - {"outcome=won", "outcome=fell_back"}
            or bound_opt <= bound_greedy):
        raise AssertionError(f"mock optimal bound {bound_opt} (outcomes "
                             f"{outcomes}) against greedy {bound_greedy}")
    out["mock"] = {"bound_optimal": bound_opt, "bound_greedy": bound_greedy,
                   "pack_outcomes": outcomes, "wall_s": wall}
    out["profiles"] = duel_profiles(dev)
    return out


def learned_inputs(rng, N, M, G, R, E, dev, active_share=0.9):
    """learned_propose's inputs shaped like the solve's, with random
    embeddings of width E (scale 0.3, so that scores spread over about one
    unit), a row mask and a key: a dict of the kernel's keyword
    arguments."""
    from yunikorn_tpu_torch.utils import prng

    base = random_kernel_inputs(rng, N, M, G, R, dev)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(
        pod_emb=t((rng.standard_normal((N, E)) * 0.3).astype(np.float32)),
        node_emb=t((rng.standard_normal((M, E)) * 0.3).astype(np.float32)),
        group_id=base["group_id"], group_feas=base["group_feas"],
        free=base["free"], req=base["req"],
        active=t(rng.random(N) < active_share), tau=0.25,
        key=prng.prng_key(int(rng.integers(0, 2**31)), dev),
        rnd=int(rng.integers(0, 16)), chunk=512)


def check_proposals(got, ref, inp):
    """Hold the kernel's (prop, pick, nf, lmean) against the plain
    version's on the same inputs: nf equal, lmean within LEARNED_LMEAN_TOL
    x max(1, |lmean|), and pick and prop equal except on near-ties,
    counted: a pick may differ
    only where the plain version's top two scores u lie within
    LEARNED_NEAR_TIE, the gate only where ls at the pick lies within it of
    lmean + GATE_MARGIN. Raises on anything else; returns the counts."""
    from yunikorn_tpu_torch.ops.learned import chunk_scores
    from yunikorn_tpu_torch.policy.net import GATE_MARGIN
    from yunikorn_tpu_torch.utils import prng

    prop, pick, nf, lmean = got
    rprop, rpick, rnf, rlmean = ref
    if not torch.equal(nf, rnf):
        raise AssertionError(f"nf differs on {int((nf != rnf).sum())} rows")
    diff = (lmean - rlmean).abs()
    scale = rlmean.abs().clamp(min=1.0)
    lm_err = float(diff.max()) if diff.numel() else 0.0
    lm_rel = float((diff / scale).max()) if diff.numel() else 0.0
    if lm_rel > LEARNED_LMEAN_TOL:
        raise AssertionError(f"lmean off the plain version's by {lm_err} "
                             f"({lm_rel} of max(1, |lmean|))")
    bad = ((pick != rpick) | (prop != rprop)).nonzero().squeeze(1).tolist()
    chunk = inp["chunk"]
    round_key = prng.fold_in(inp["key"], inp["rnd"])
    pick_ties = gate_ties = 0
    for c in sorted({i // chunk for i in bad}):
        ok, ls, u = chunk_scores(inp["pod_emb"], inp["node_emb"],
                                 inp["group_id"], inp["group_feas"],
                                 inp["free"], inp["req"], inp["tau"],
                                 round_key, c, chunk)
        for i in [i for i in bad if i // chunk == c]:
            row = u[i - c * chunk]
            top2 = row.topk(2).values
            if pick[i] != rpick[i]:
                if float(top2[0] - top2[1]) > LEARNED_NEAR_TIE:
                    raise AssertionError(f"row {i}: pick {int(pick[i])} != "
                                         f"{int(rpick[i])} off a near-tie")
                pick_ties += 1
            else:
                margin = float(ls[i - c * chunk, rpick[i]] - rlmean[i])
                if abs(margin - GATE_MARGIN) > LEARNED_NEAR_TIE:
                    raise AssertionError(f"row {i}: gate differs at margin "
                                         f"{margin}")
                gate_ties += 1
    return {"rows": int(nf.numel()), "pick_near_ties": pick_ties,
            "gate_near_ties": gate_ties, "lmean_max_abs_err": lm_err,
            "lmean_max_rel_err": lm_rel,
            "overrides": int((prop < inp["free"].shape[0]).sum())}


def learned_propose_bound_ms(inp, clock_hz: float) -> dict:
    """Least time for one learned_propose call: inputs read once and
    outputs written once over HBM bandwidth, against its operations on the
    active rows: R fit compares per pair the group row admits, and per
    fitting pair LEARNED_INT_OPS integer operations at 64 a clock per SM,
    LEARNED_SFU_OPS logf at SFU_PER_CLK_SM, and 2E - 1 + LEARNED_FP_OPS
    float32 operations at 128; the pipes issue side by side, so the
    slowest bounds."""
    req, free = inp["req"], inp["free"]
    N, R = req.shape
    G, M = inp["group_feas"].shape
    E = inp["pod_emb"].shape[1]
    n_rows, admitted, fitting = pair_counts(req, inp["group_id"],
                                            inp["group_feas"], free,
                                            inp["active"])
    sm_clk = SMS * clock_hz
    int_s = (admitted * R + fitting * LEARNED_INT_OPS) / (CMP_PER_CLK_SM
                                                          * sm_clk)
    sfu_s = fitting * LEARNED_SFU_OPS / (SFU_PER_CLK_SM * sm_clk)
    fp_s = fitting * (2 * E - 1 + LEARNED_FP_OPS) / (FADD_PER_CLK_SM * sm_clk)
    t_ops = max(int_s, sfu_s, fp_s) * 1e3
    nbytes = (N * R * 4 + N * 4 + G * M + M * R * 4 + N + (N + M) * E * 4
              + 16 + N * 16)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    pipe = max((int_s, "integer"), (sfu_s, "sfu"), (fp_s, "float32"))[1]
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pipe": pipe, "rows": n_rows, "pairs": admitted,
            "fitting_pairs": fitting}


def learned_kernels(dev, stats, clock_hz):
    """Both kernels of the learned path against their plain versions on the
    card at full width (N 65,536, M 16,384, E 16, R 8, G 4): learned_propose
    on random inputs (90% of the rows active), with a narrower embedding
    (E 8, zero-padded to the kernel's 16), E 32, every row inactive, and
    R 12; best_nodes' learned term bit-equal, with and without the
    planned-domain bonus and a row mask. Then CUDA-event ms of the kernel
    and of the plain version, and the bound."""
    from yunikorn_tpu_torch.ops.best_nodes import (best_nodes,
                                                   best_nodes_reference)
    from yunikorn_tpu_torch.ops.learned import (learned_propose,
                                                learned_propose_reference)

    rng = np.random.default_rng(20261017)
    N, M, G = 65_536, 16_384, 4
    full = learned_inputs(rng, N, M, G, 8, 16, dev)
    cases = [("full_width", full),
             ("e8", learned_inputs(rng, N, M, G, 8, 8, dev)),
             ("e32", learned_inputs(rng, 8_192, M, G, 8, 32, dev)),
             ("none_active", dict(full, active=torch.zeros_like(
                 full["active"]))),
             ("r12", learned_inputs(rng, 8_192, M, G, 12, 16, dev))]
    checks = {}
    for label, inp in cases:
        got = learned_propose(**inp)
        torch.cuda.synchronize()
        checks[label] = check_proposals(
            got, learned_propose_reference(**inp), inp)
    bn_cases = []
    for label, kw in (("learned", {}), ("learned_rows", {
            "rows": random_rows(rng, N, N * 3 // 10, dev)}), (
            "learned_bonus", {
                "node_dom": torch.from_numpy(rng.integers(
                    -1, 32, M).astype(np.int32)).to(dev),
                "pref": torch.from_numpy(rng.integers(
                    -1, 32, N).astype(np.int32)).to(dev)})):
        base = random_kernel_inputs(rng, N, M, G, 8, dev)
        emb = dict(pod_emb=full["pod_emb"], node_emb=full["node_emb"])
        got = best_nodes(**base, mode="exact", has_soft=True, **emb, **kw)
        torch.cuda.synchronize()
        ref = best_nodes_reference(**base, mode="exact", has_soft=True,
                                   **emb, **kw)
        equal = bool(torch.equal(got[0], ref[0])
                     and torch.equal(got[1], ref[1]))
        bn_cases.append({"case": label, "equal": equal,
                         "feasible": int(got[1].sum())})
        if not equal:
            raise AssertionError(f"best_nodes' learned term differs from "
                                 f"its plain version: {label}")
    ms = cuda_ms(lambda: learned_propose(**full), 10)
    plain_ms = cuda_ms(lambda: learned_propose_reference(**full), 1)
    bound = learned_propose_bound_ms(full, clock_hz)
    stats.setdefault("learned_propose", {})
    return {"propose": checks, "best_nodes_learned": bn_cases, "ms": ms,
            "plain_ms": plain_ms, "bound": bound,
            "share_of_bound": bound["bound_ms"] / ms}


def learned_fleet(n_pods, n_nodes, seed):
    """scripts/policy_bench.py's build through the port: the two-flavor
    fleet and the mixed wave of `seed`, one app: (encoder, batch,
    priorities)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import (make_pack_nodes,
                                                     make_pack_pods, pack_asks)
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    for node in make_pack_nodes(n_nodes):
        cache.update_node(node)
    asks, prio, ranks = pack_asks(
        make_pack_pods(n_pods, seed=seed, app_id="policy-app"),
        app_id="policy-app")
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return enc, enc.build_batch(asks, ranks=ranks), prio


def learned_eval(dev):
    """policy_bench's evaluation on the card: the eval shape with the
    committed checkpoint (seed LEARNED_SEED) and an untrained one
    (init_params(1), policy_bench's), warm ms of greedy and learned (median
    of 5), the duel; greedy exactly the JAX package's, learned within
    LEARNED_UNITS_RTOL, its winner, the untrained plan bit-identical to
    greedy's (all four outputs)."""
    from yunikorn_tpu_torch.ops import pack_solve
    from yunikorn_tpu_torch.ops.assign import solve_batch
    from yunikorn_tpu_torch.policy import net

    ck = net.load_checkpoint(LEARNED_CKPT)
    if ck.hash != LEARNED_HASH:
        raise AssertionError(f"checkpoint hash {ck.hash} != {LEARNED_HASH}")
    n_pods, n_nodes, seed = LEARNED_EVAL
    enc, batch, prio = learned_fleet(n_pods, n_nodes, seed)
    n = batch.num_pods
    params = net.params_from_numpy(ck.params, dev)
    untrained = net.params_from_numpy(net.init_params(1), dev)
    run = lambda learned=None: solve_batch(  # noqa: E731
        batch, enc.nodes, device=dev, learned=learned, **SOLVE_KW)
    greedy_ms, g = warm_median_ms(run)
    learned_ms, lr = warm_median_ms(lambda: run((params, LEARNED_SEED)))
    u = run((untrained, LEARNED_SEED))
    same = {f: bool(torch.equal(getattr(g, f), getattr(u, f)))
            for f in ("assigned", "accept_round", "free_after")}
    same["rounds"] = g.rounds == u.rounds
    if not all(same.values()):
        raise AssertionError(f"untrained plan differs from greedy: {same}")
    for name, res in (("greedy", g), ("learned", lr)):
        if int(res.free_after.min()) < 0:
            raise AssertionError(f"{name} over-committed a node")
    winner, st = pack_solve.choose_plan_n(
        [("greedy", g.assigned[:n].cpu().numpy()),
         ("learned", lr.assigned[:n].cpu().numpy())],
        batch.req.astype(np.int32), batch.valid,
        cap_i=np.floor(enc.nodes.capacity_arr).astype(np.int64),
        priorities=np.asarray(prio))
    got = {k: (st[k]["placed"], st[k]["units_norm"]) for k in st}
    want_winner, want = EXPECTED_LEARNED
    if (got["greedy"][0], round(got["greedy"][1], 3)) != want["greedy"]:
        raise AssertionError(f"greedy {got['greedy']} != the JAX "
                             f"package's {want['greedy']}")
    for i, what in ((0, "placed"), (1, "units")):
        if abs(got["learned"][i] - want["learned"][i]) \
                > LEARNED_UNITS_RTOL * want["learned"][i]:
            raise AssertionError(f"learned {what} {got['learned']} off the "
                                 f"JAX package's {want['learned']}")
    if winner != want_winner:
        raise AssertionError(f"duel winner {winner} != {want_winner}")
    return {"pods": n_pods, "nodes": n_nodes, "checkpoint": ck.hash,
            "placed_units": got, "expected": want, "winner": winner,
            "util_ratio": got["learned"][1] / got["greedy"][1],
            "rounds": {"greedy": g.rounds, "learned": lr.rounds},
            "warm_ms": {"greedy": greedy_ms, "learned": learned_ms},
            "untrained_identical": same}


def learned_core_full(dev, stats):
    """solver.policy=learned through the core at full width: the pressure
    mix, 10,000 nodes x 50,000 pods, the committed checkpoint. A warm-up
    cycle and a release, then the measured cycle with every kernel's
    launch count set to 0 just before and read just after (best_nodes'
    split between the greedy dispatch and the learned one); then, on the
    same core, the untrained checkpoint: the learned plan equal to the
    greedy plan, which stands."""
    from yunikorn_tpu_torch.client.synthetic import (PRESSURE_APPS,
                                                     make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.core.scheduler import SolverOptions
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes
    from yunikorn_tpu_torch.ops.learned import (learned_propose,
                                                learned_propose_finish)
    from yunikorn_tpu_torch.policy import net

    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(PRESSURE_APPS))]
    cache, core, cb = make_core(dev, make_pressure_nodes(MAIN_NODES), apps,
                                SolverOptions(policy="learned",
                                              policy_checkpoint=LEARNED_CKPT))
    asks = asks_of(make_pressure_pods(MAIN_PODS))
    core_cycle(core, asks)
    release_all(core, asks)
    split = {"greedy": 0, "learned": 0}

    def counted(name, fn):
        def run(*a, **kw):
            before = best_nodes.launches
            try:
                return fn(*a, **kw)
            finally:
                split[name] += best_nodes.launches - before
        return run

    dispatch, learned_dispatch = core._dispatch_solve, core._learned_dispatch
    core._dispatch_solve = counted("greedy", dispatch)
    core._learned_dispatch = counted("learned", learned_dispatch)
    try:
        best_nodes.launches = 0
        learned_propose.launches = 0
        learned_propose_finish.launches = 0
        n, cycle_s = core_cycle(core, asks)
        launches = {"best_nodes": best_nodes.launches,
                    "learned_propose": learned_propose.launches,
                    "learned_propose_finish": learned_propose_finish.launches}
    finally:
        core._dispatch_solve = dispatch
        core._learned_dispatch = learned_dispatch
    entry = dict(core.metrics["last_cycle"]["default"])
    outcomes = core.metrics.get("policy_plans_total") or {}
    check_tiers(core, "learned core")
    if set(outcomes) - {"outcome=won", "outcome=fell_back"} or not outcomes:
        raise AssertionError(f"policy outcomes {outcomes}, skip "
                             f"{entry.get('policy_skip')}")
    if (launches["learned_propose"] < 1
            or launches["learned_propose_finish"]
            != launches["learned_propose"]
            or split["greedy"] < 1
            or split["learned"] < 1
            or launches["best_nodes"] != split["greedy"] + split["learned"]):
        raise AssertionError(f"launches {launches}, best_nodes {split}")
    nodes_used = check_bindings(cache, cb.bound, asks)
    stats.setdefault("learned_propose", {}).update(
        launches=launches["learned_propose"],
        launches_finish=launches["learned_propose_finish"])
    stats.setdefault("best_nodes", {})["launches_learned"] = \
        launches["best_nodes"]
    stats["best_nodes"]["launches_learned_arm"] = split["learned"]
    out = {"nodes": MAIN_NODES, "pods": MAIN_PODS, "placed": n,
           "cycle_ms": cycle_s * 1e3, "split": cycle_split(core),
           "winner": entry.get("solver_policy"),
           "learned_util": entry.get("learned_util"),
           "learned_ms": entry.get("learned_ms"),
           "learned_placed": entry.get("learned_placed"),
           "checkpoint": entry.get("checkpoint"),
           "policy_outcomes": outcomes, "launches": launches,
           "best_nodes_split": split, "nodes_used": nodes_used,
           "oversubscribed": 0}

    # the untrained checkpoint on the same core: the learned plan is the
    # greedy plan
    release_all(core, asks)
    prefix = os.path.join(ROOT, "build", "policy_untrained")
    net.save_checkpoint(prefix, net.init_params(0), epoch=0)
    if not core.set_policy_checkpoint(prefix):
        raise AssertionError("the untrained checkpoint was rejected")
    same = []
    duel = core._plan_duel

    def duel_spy(h, greedy_assigned):
        k = h.batch.num_pods
        same.append(np.array_equal(h.learned.assigned[:k].cpu().numpy(),
                                   np.asarray(greedy_assigned)[:k]))
        return duel(h, greedy_assigned)

    core._plan_duel = duel_spy
    try:
        n_untrained, _ = core_cycle(core, asks)
    finally:
        core._plan_duel = duel
    entry = core.metrics["last_cycle"]["default"]
    if (same != [True] or entry.get("solver_policy") != "greedy"
            or entry.get("learned_util") != 1.0):
        raise AssertionError(f"untrained: plans equal {same}, entry "
                             f"{entry.get('solver_policy')} "
                             f"{entry.get('learned_util')}")
    out["untrained"] = {"placed": n_untrained, "plan_equal_greedy": True,
                        "winner": entry.get("solver_policy")}
    return out


def learned_all_cut(dev):
    """solver.policy=all through the core on the pressure mix at
    ALL_CUT_NODES x ALL_CUT_PODS (every arm: pack, cvx with the learned
    duals, learned), on the card and on the CPU: the same winner, each
    arm's units within the duel bar (DUEL_UNITS_RTOL), no node over its
    allocatable."""
    from yunikorn_tpu_torch.client.synthetic import (PRESSURE_APPS,
                                                     make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.core.scheduler import SolverOptions

    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(PRESSURE_APPS))]
    out = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        cache, core, cb = make_core(where,
                                    make_pressure_nodes(ALL_CUT_NODES),
                                    apps, SolverOptions(
                                        policy="all",
                                        policy_checkpoint=LEARNED_CKPT))
        asks = asks_of(make_pressure_pods(ALL_CUT_PODS))
        n, cycle_s = core_cycle(core, asks)
        check_bindings(cache, cb.bound, asks)
        entry = core.metrics["last_cycle"]["default"]
        out[label] = {
            "placed": n, "cycle_ms": cycle_s * 1e3,
            "winner": entry.get("solver_policy"),
            "pack_util": entry.get("pack_util"),
            "cvx_util": entry.get("cvx_util"),
            "learned_util": entry.get("learned_util"),
            "learned_dual": entry.get("learned_dual"),
            "placed_by_arm": {"greedy": entry.get("greedy_placed"),
                              "optimal": entry.get("pack_placed"),
                              "cvx": entry.get("cvx_placed"),
                              "learned": entry.get("learned_placed")},
            "duel_wins": core.metrics.get("duel_wins_total")}
    out["shape"] = (ALL_CUT_NODES, ALL_CUT_PODS)
    card, cpu = out["card"], out["cpu"]
    if card["winner"] != cpu["winner"]:
        raise AssertionError(f"winner {card['winner']} on the card, "
                             f"{cpu['winner']} on the CPU")
    for arm in ("pack_util", "cvx_util", "learned_util"):
        if card[arm] is None or cpu[arm] is None or (
                abs(card[arm] - cpu[arm]) > DUEL_UNITS_RTOL * cpu[arm]):
            raise AssertionError(f"{arm} {card[arm]} on the card, {cpu[arm]} "
                                 "on the CPU")
    if not card["learned_dual"]:
        raise AssertionError("the cvx arm ran without the learned duals")
    return out


def learned_solve_calls(batch, enc, params, dev, stats, clock_hz):
    """One full-width learned solve with a copy of every learned_propose
    call's inputs; then each call again at its own inputs: the rows it
    asked for, CUDA-event ms and the bound; the first round's call held
    against the plain version, whose ms it also reports. The kernels line
    takes the first round's numbers (the main path's own call)."""
    from yunikorn_tpu_torch.ops import assign
    from yunikorn_tpu_torch.ops import learned as lmod

    real = lmod.learned_propose
    with capturing_learned_propose() as captured:
        res = assign.solve_batch(batch, enc.nodes, device=dev,
                                 learned=(params, LEARNED_SEED), **SOLVE_KW)
    captured = [whole_call(inp) for inp in captured["shard"]]
    calls = []
    for inp in captured:
        b = learned_propose_bound_ms(inp, clock_hz)
        calls.append({"round": inp["rnd"], "rows": b["rows"],
                      "fitting_pairs": b["fitting_pairs"],
                      "ms": cuda_ms(lambda: real(**inp), 5),
                      "bound_ms": b["bound_ms"], "pipe": b["pipe"]})
    first = captured[0]
    check = check_proposals(real(**first),
                            lmod.learned_propose_reference(**first), first)
    plain_ms = cuda_ms(lambda: lmod.learned_propose_reference(**first), 1)
    stats["learned_propose"].update(
        max_abs_err=check["lmean_max_abs_err"], ms=calls[0]["ms"],
        plain_ms=plain_ms, bound_ms=calls[0]["bound_ms"],
        bound_by=learned_propose_bound_ms(first, clock_hz)["bound_by"],
        library_ms=None)
    return {"rounds": res.rounds, "calls": calls, "first_round_check": check,
            "first_round_plain_ms": plain_ms,
            "kernel_ms_per_solve": sum(c["ms"] for c in calls),
            "bound_ms_per_solve": sum(c["bound_ms"] for c in calls)}


def phase_learned(dev, stats, clock_hz):
    """The learned policy's serving path (solver.policy=learned and all):
    both kernels of the path against their plain versions at full width,
    policy_bench's evaluation with the committed checkpoint, the core at
    full width with its launch counts, solver.policy=all at ALL_CUT_NODES x
    ALL_CUT_PODS on the card and the CPU, and one full-width learned solve: learned_propose's
    calls at their own inputs, warm ms against greedy's and a device
    profile."""
    from yunikorn_tpu_torch.ops.assign import solve_batch
    from yunikorn_tpu_torch.policy import net

    out = {"kernels": learned_kernels(dev, stats, clock_hz),
           "eval": learned_eval(dev),
           "core_full": learned_core_full(dev, stats),
           "all_cut": learned_all_cut(dev)}
    enc, batch, _, _ = build_workload(MAIN_NODES, MAIN_PODS)
    params = net.params_from_numpy(net.load_checkpoint(LEARNED_CKPT).params,
                                   dev)
    out["propose_calls"] = learned_solve_calls(batch, enc, params, dev,
                                               stats, clock_hz)
    solve = lambda learned=None: solve_batch(  # noqa: E731
        batch, enc.nodes, device=dev, learned=learned, **SOLVE_KW)
    g_ms, g = warm_median_ms(solve, runs=3)
    l_ms, lr = warm_median_ms(lambda: solve((params, LEARNED_SEED)), runs=3)
    out["solve_full"] = {
        "warm_ms": {"greedy": g_ms, "learned": l_ms},
        "rounds": {"greedy": g.rounds, "learned": lr.rounds},
        "placed": {"greedy": int((g.assigned >= 0).sum()),
                   "learned": int((lr.assigned >= 0).sum())},
        "profile": profile_solve(
            lambda: solve((params, LEARNED_SEED)), top=12)}
    return out


def train_record(dev, writer, n_pods, n_nodes, seeds):
    """scripts/policy_bench.py's recording through the port on `dev`: one
    greedy-vs-pack duel (arm seed DUEL_SEED) per fleet seed on the
    two-flavor fleet, each written in the policy_recorder format. Returns
    the winners' counts."""
    from yunikorn_tpu_torch.ops import pack_solve
    from yunikorn_tpu_torch.ops.assign import solve_batch

    winners = {}
    for s in seeds:
        enc, batch, prio = learned_fleet(n_pods, n_nodes, s)
        n = batch.num_pods
        ga = solve_batch(batch, enc.nodes, device=dev).assigned[:n]
        pa = pack_solve.pack_solve_batch(batch, enc.nodes, seed=DUEL_SEED,
                                         device=dev).assigned[:n]
        ga, pa = ga.cpu().numpy(), pa.cpu().numpy()
        na = enc.nodes
        cap = np.floor(na.capacity_arr).astype(np.int64)
        winner, _ = pack_solve.choose_plan_n(
            [("greedy", ga), ("optimal", pa)], batch.req.astype(np.int32),
            batch.valid, cap_i=cap, priorities=np.asarray(prio))
        writer({"req": batch.req.astype(np.int32),
                "rank": np.asarray(batch.rank),
                "valid": np.asarray(batch.valid),
                "free0": np.floor(na.free).astype(np.int32),
                "cap": cap.astype(np.int32),
                "node_ok": np.asarray(na.valid & na.schedulable),
                "priorities": np.asarray(prio), "score_cols":
                int(batch.req.shape[1]), "winner": winner,
                "plan_greedy": ga, "plan_optimal": pa})
        winners[winner] = winners.get(winner, 0) + 1
    return winners


def train_eval(dev, params):
    """policy_bench's evaluation of host-form `params` on `dev` at
    LEARNED_EVAL (learned seed LEARNED_SEED): each plan's (placed, units),
    the winner and the learned/greedy units ratio."""
    from yunikorn_tpu_torch.ops import pack_solve
    from yunikorn_tpu_torch.ops.assign import solve_batch
    from yunikorn_tpu_torch.policy import net

    enc, batch, prio = learned_fleet(*LEARNED_EVAL)
    n = batch.num_pods
    learned = (net.params_from_numpy(params, dev), LEARNED_SEED)
    g, lr = (solve_batch(batch, enc.nodes, device=dev, learned=x,
                         **SOLVE_KW) for x in (None, learned))
    for name, res in (("greedy", g), ("learned", lr)):
        if int(res.free_after.min()) < 0:
            raise AssertionError(f"{name} over-committed a node")
    winner, st = pack_solve.choose_plan_n(
        [("greedy", g.assigned[:n].cpu().numpy()),
         ("learned", lr.assigned[:n].cpu().numpy())],
        batch.req.astype(np.int32), batch.valid,
        cap_i=np.floor(enc.nodes.capacity_arr).astype(np.int64),
        priorities=np.asarray(prio))
    got = {k: (st[k]["placed"], round(st[k]["units_norm"], 3)) for k in st}
    return {"placed_units": got, "winner": winner,
            "util_ratio": st["learned"]["units_norm"]
            / st["greedy"]["units_norm"]}


def timed_fit(examples, dev, epochs, **kw):
    """policy/train.fit on `dev` with its steps timed: (params, report,
    timing) with the median ms of an imitation and of a fine-tune step,
    the fit's seconds and, on the card, its peak device memory."""
    from yunikorn_tpu_torch.policy import train

    steps = {}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, report = train.fit(examples, seed=0, imitation_epochs=epochs[0],
                               finetune_epochs=epochs[1], device=dev,
                               step_times=steps, **kw)
    timing = {"fit_s": time.perf_counter() - t0}
    for name, ts in steps.items():
        timing[f"{name}_step_ms"] = statistics.median(ts) * 1e3
        timing[f"{name}_steps"] = len(ts)
    if dev.type == "cuda":
        timing["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return params, report, timing


def train_bench(dev):
    """scripts/policy_bench.py --train at its defaults through the port:
    TRAIN_CYCLES greedy-vs-pack duels at TRAIN_SHAPE recorded into a port
    DatasetWriter, fit on the card (TRAIN_EPOCHS) twice — the same params
    hash — and once on the CPU, each checkpoint evaluated at LEARNED_EVAL
    on the card. Bar (policy_bench's --assert-quality): the card's
    checkpoint wins with learned units >= TRAIN_MIN_WIN x greedy's and no
    fewer placed."""
    import tempfile

    from yunikorn_tpu_torch.policy import net, train

    ds = tempfile.mkdtemp(prefix="yk-train-")
    t0 = time.perf_counter()
    winners = train_record(dev, train.DatasetWriter(ds), *TRAIN_SHAPE,
                           range(TRAIN_CYCLES))
    record_s = time.perf_counter() - t0
    examples = train.load_dataset(ds)
    fits = [timed_fit(examples, dev, TRAIN_EPOCHS) for _ in range(2)]
    cpu = timed_fit(examples, torch.device("cpu"), TRAIN_EPOCHS)
    hashes = [net.params_hash(p) for p, _, _ in fits]
    if hashes[0] != hashes[1]:
        raise AssertionError(f"two fits on the card differ: {hashes}")
    if fits[0][1] != fits[1][1]:
        raise AssertionError("two fits on the card report other losses")
    prefix = os.path.join(ROOT, "build", "policy_trained_card")
    ck = net.save_checkpoint(prefix, fits[0][0],
                             epoch=sum(TRAIN_EPOCHS),
                             meta={"cycles": len(examples)})
    ev = train_eval(dev, net.load_checkpoint(prefix).params)
    ev_cpu = train_eval(dev, cpu[0])
    g, lr = ev["placed_units"]["greedy"], ev["placed_units"]["learned"]
    if (ev["winner"] != "learned" or ev["util_ratio"] < TRAIN_MIN_WIN
            or lr[0] < g[0]):
        raise AssertionError(f"the card's checkpoint: {ev}")
    return {"shape": TRAIN_SHAPE, "cycles": len(examples),
            "winners": winners, "record_s": record_s,
            "epochs": TRAIN_EPOCHS, "hash_card": ck.hash,
            "hash_card_again": hashes[1], "hash_cpu": net.params_hash(cpu[0]),
            "report_card": fits[0][1], "report_cpu": cpu[1],
            "timing_card": [t for _, _, t in fits], "timing_cpu": cpu[2],
            "eval_card": ev, "eval_cpu_checkpoint": ev_cpu,
            "committed_checkpoint": EXPECTED_LEARNED[1]}


def train_full(dev, stats):
    """The trainer at full width: duel_core_full's optimal core (the
    pressure mix, 10,000 x 50,000; N 65,536, M 16,384) with
    core.policy_recorder set to a DatasetWriter records its duel cycle;
    a fit of FULL_FIT_EPOCHS at that shape on the card (ms a step of each
    phase, peak memory); the checkpoint served by the learned core at
    full width with every kernel's launches counted from 0 around its
    cycle. Bars: one cycle recorded at the full shape, no failed learned
    plan, every binding fits its node."""
    import gc
    import tempfile

    from yunikorn_tpu_torch.client.synthetic import (PRESSURE_APPS,
                                                     make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.core.scheduler import SolverOptions
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes
    from yunikorn_tpu_torch.ops.learned import learned_propose
    from yunikorn_tpu_torch.policy import net, train

    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(PRESSURE_APPS))]
    nodes = make_pressure_nodes(MAIN_NODES)
    asks = asks_of(make_pressure_pods(MAIN_PODS))
    ds = tempfile.mkdtemp(prefix="yk-train-full-")
    writer = train.DatasetWriter(ds)
    _, core, _ = make_core(dev, nodes, apps, SolverOptions(policy="optimal"))
    core.policy_recorder = writer
    n_optimal, cycle_s = core_cycle(core, asks)
    entry = dict(core.metrics["last_cycle"]["default"])
    core.stop()
    del core
    gc.collect()
    examples = train.load_dataset(ds)
    if writer.written != 1 or len(examples) != 1:
        raise AssertionError(f"{writer.written} duel cycles recorded")
    shape = {"pods": int(examples[0]["req"].shape[0]),
             "nodes": int(examples[0]["free0"].shape[0]),
             "winner": examples[0]["winner"],
             "plans": sorted(k for k in examples[0] if k.startswith("plan_"))}
    if (shape["pods"], shape["nodes"]) != FULL_SHAPE:
        raise AssertionError(f"recorded cycle {shape}")
    torch.cuda.empty_cache()
    params, report, timing = timed_fit(examples, dev, FULL_FIT_EPOCHS)
    del examples
    gc.collect()
    torch.cuda.empty_cache()
    prefix = os.path.join(ROOT, "build", "policy_trained_full")
    ck = net.save_checkpoint(prefix, params, epoch=sum(FULL_FIT_EPOCHS))
    cache, core, cb = make_core(dev, nodes, apps, SolverOptions(
        policy="learned", policy_checkpoint=prefix))
    try:
        best_nodes.launches = 0
        learned_propose.launches = 0
        n, serve_s = core_cycle(core, asks)
        launches = {"best_nodes": best_nodes.launches,
                    "learned_propose": learned_propose.launches}
        served = dict(core.metrics["last_cycle"]["default"])
        outcomes = core.metrics.get("policy_plans_total") or {}
        check_tiers(core, "learned core (trained checkpoint)")
        nodes_used = check_bindings(cache, cb.bound, asks)
    finally:
        core.stop()
    if outcomes.get("outcome=failed") or not outcomes:
        raise AssertionError(f"policy outcomes {outcomes}")
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"kernel launches {launches}")
    if served.get("checkpoint") != ck.hash:
        raise AssertionError(f"served {served.get('checkpoint')} != {ck.hash}")
    stats.setdefault("best_nodes", {})["launches_train"] = \
        launches["best_nodes"]
    stats.setdefault("learned_propose", {})["launches_train"] = \
        launches["learned_propose"]
    return {"recorded": shape, "optimal_cycle": {
                "placed": n_optimal, "cycle_ms": cycle_s * 1e3,
                "winner": entry.get("solver_policy"),
                "pack_util": entry.get("pack_util")},
            "epochs": FULL_FIT_EPOCHS, "report": report, "timing": timing,
            "checkpoint": ck.hash, "served": {
                "placed": n, "cycle_ms": serve_s * 1e3,
                "winner": served.get("solver_policy"),
                "learned_util": served.get("learned_util"),
                "learned_placed": served.get("learned_placed"),
                "learned_ms": served.get("learned_ms"),
                "policy_outcomes": outcomes, "launches": launches,
                "nodes_used": nodes_used, "oversubscribed": 0}}


def phase_train(dev, stats):
    """The learned policy's trainer on the card: policy_bench's --train
    through the port (record, fit twice and on the CPU, evaluate), then
    the full-width record -> fit -> serve loop."""
    return {"bench": train_bench(dev), "full": train_full(dev, stats)}


class ThreadSampler:
    """Where the host's CPU time goes over a run: every `period` seconds
    each thread's CPU time (user + system, Linux /proc/self/task, in clock
    ticks of 1/SC_CLK_TCK s) is read, and what it spent since the last read
    is counted for its thread group (the thread's name without its trailing
    index) and for the module of the port on top of its stack at the read
    ("other" when none is). A thread that ends between two reads loses its
    last interval."""

    def __init__(self, period: float = 0.02):
        import threading

        self.period = period
        self.tick = os.sysconf("SC_CLK_TCK")
        self.cpu = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="sampler",
                                        daemon=True)

    @staticmethod
    def group(name: str) -> str:
        import re

        return re.sub(r"[-_]?(s\d+w\d+|\d+)$", "", name)

    def _times(self, path="/proc/self/task"):
        out = {}
        for tid in os.listdir(path):
            try:
                with open(f"{path}/{tid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
                out[int(tid)] = (int(fields[11]) + int(fields[12])) / self.tick
            except (OSError, IndexError, ValueError):
                continue
        return out

    def _process_cpu(self) -> float:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / self.tick

    def _read(self, last) -> None:
        import threading

        pkg = os.sep + "yunikorn_tpu_torch" + os.sep
        frames = sys._current_frames()
        threads = {t.native_id: t for t in threading.enumerate()}
        for nid, cpu in self._times().items():
            spent = cpu - last.get(nid, 0.0)
            last[nid] = cpu
            t = threads.get(nid)
            if spent <= 0 or t is self._thread:
                continue
            if t is None:   # not a Python thread: PyTorch's or CUDA's
                self.cpu[("native", "other")] = self.cpu.get(
                    ("native", "other"), 0.0) + spent
                continue
            where, f = "other", frames.get(t.ident)
            while f is not None:
                if pkg in f.f_code.co_filename:
                    where = f.f_code.co_filename.split(pkg, 1)[1]
                    break
                f = f.f_back
            key = (self.group(t.name), where)
            self.cpu[key] = self.cpu.get(key, 0.0) + spent

    def _run(self) -> None:
        last = dict(self._start)
        while not self._stop.wait(self.period):
            self._read(last)
        self._read(last)

    def __enter__(self):
        self._start = self._times()
        self._cpu0 = self._process_cpu()
        self._t0 = time.perf_counter()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.wall_s = time.perf_counter() - self._t0
        self.process_cpu_s = self._process_cpu() - self._cpu0

    def report(self, top: int = 5) -> dict:
        """Process CPU s and wall s, and per thread group its CPU s and
        the modules it spent the most CPU in."""
        groups = {}
        for (group, where), cpu in self.cpu.items():
            g = groups.setdefault(group, {"cpu_s": 0.0, "modules": {}})
            g["cpu_s"] += cpu
            g["modules"][where] = g["modules"].get(where, 0.0) + cpu
        for g in groups.values():
            g["modules"] = dict(sorted(g["modules"].items(),
                                       key=lambda kv: -kv[1])[:top])
        return {"wall_s": self.wall_s, "process_cpu_s": self.process_cpu_s,
                "groups": dict(sorted(groups.items(),
                                      key=lambda kv: -kv[1]["cpu_s"]))}


def check_fake_cluster(ms):
    """No node of the fake API server holds bound pods requesting more
    than its allocatable: (nodes used, pods bound)."""
    from yunikorn_tpu_torch.common.resource import (Resource,
                                                    get_node_resource,
                                                    get_pod_resource)

    used = {}
    for pod in ms.cluster.list_pods():
        if pod.spec.node_name:
            used[pod.spec.node_name] = used.get(
                pod.spec.node_name, Resource()).add(get_pod_resource(pod))
    for name, total in used.items():
        alloc = get_node_resource(ms.cluster.get_node(name).status.allocatable)
        if not total.fits_in(alloc):
            raise AssertionError(f"node {name} over its allocatable at the "
                                 f"API server: {total} > {alloc}")
    return len(used), sum(1 for p in ms.cluster.list_pods()
                          if p.spec.node_name)


def shim_bench_shape(dev):
    """bench.py's shim run (bench.py:667-746) on the port's MockScheduler
    on `dev`: 10,000 kwok nodes x 50,000 sleep pods in 5 queues, the pods
    in the cluster before start (the shim's recovery lists them), WARN
    logging, measured first bind to last bind."""
    from yunikorn_tpu_torch.client.synthetic import (make_kwok_nodes,
                                                     make_sleep_pods)
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes
    from yunikorn_tpu_torch.shim.mock_scheduler import MockScheduler

    ms = MockScheduler()
    ms.init(interval=0.05, core_interval=0.05,
            conf_extra={"log.level": "WARN"}, device=dev)
    entries = []
    record = ms.core._record_cycle_entry

    def spy(pname, entry):
        entries.append(dict(entry))
        record(pname, entry)

    ms.core._record_cycle_entry = spy
    try:
        for node in make_kwok_nodes(MAIN_NODES):
            ms.cluster.add_node(node)
        pods = []
        for q in range(5):
            pods.extend(make_sleep_pods(
                MAIN_PODS // 5, f"bench-shim-{q}", queue=f"root.q{q}",
                name_prefix=f"sq{q}"))
        for pod in pods:
            ms.cluster.add_pod(pod)
        stats = ms.bind_stats()
        best_nodes.launches = 0
        with ThreadSampler() as sampler:
            t_start = time.perf_counter()
            ms.start()
            deadline = t_start + SHIM_DEADLINE_S
            while (stats.success_count < len(pods)
                   and time.perf_counter() < deadline):
                time.sleep(0.05)
            wall = time.perf_counter() - t_start
        launches = best_nodes.launches
        if stats.success_count < len(pods):
            raise AssertionError(f"bound {stats.success_count} of "
                                 f"{len(pods)} in {wall:.1f} s (deadline "
                                 f"{SHIM_DEADLINE_S:.0f} s)")
        solves = check_tiers(ms.core, "shim")
        nodes_used, bound = check_fake_cluster(ms)
        warm = entries[1:]
        split = {k: sum(e.get(k) or 0.0 for e in warm) for k in (
            "gate_ms", "encode_ms", "solve_ms", "commit_ms", "post_ms",
            "total_ms")}
        return {"nodes": MAIN_NODES, "pods": len(pods), "bound": bound,
                "binds": stats.success_count, "bind_failures":
                stats.fail_count, "wall_s": wall,
                "pods_per_s_first_to_last_bind": stats.throughput(),
                "first_to_last_bind_s": (stats.last_bind_time
                                         - stats.first_bind_time),
                "cycles": len(entries), "cycle_pods": [e.get("pods")
                                                       for e in entries],
                "first_cycle": entries[0] if entries else None,
                "warm_cycles": len(warm), "warm_split_ms_sum": split,
                "solves": solves, "tiers": "device",
                "nodes_used": nodes_used, "oversubscribed": 0,
                "best_nodes_launches": launches,
                "host_threads": sampler.report()}
    finally:
        ms.stop()


def shim_harness(device, n_nodes, n_pods, deadline_s=180.0):
    """The pressure mix through the port's MockScheduler on `device` with
    its core not started: every pod in the cluster before the shim runs,
    the shim's pump delivers every ask, then schedule_once until a cycle
    places nothing, and every allocation's bind awaited. (allocations as
    (pod name, node) in order, pods placed per cycle)."""
    from yunikorn_tpu_torch.client.synthetic import (make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.shim.mock_scheduler import MockScheduler

    ms = MockScheduler()
    ms.init(conf_extra={"log.level": "WARN"}, device=device)
    try:
        for node in make_pressure_nodes(n_nodes):
            ms.cluster.add_node(node)
        pods = make_pressure_pods(n_pods)
        names = {p.uid: p.metadata.name for p in pods}
        for pod in pods:
            ms.cluster.add_pod(pod)
        ms.shim.run()
        allocs = []
        forward = ms.core.callback.update_allocation

        def record(response):
            allocs.extend((a.allocation_key, a.node_id) for a in response.new)
            forward(response)

        ms.core.callback.update_allocation = record

        def pending():
            with ms.core._lock:
                return sum(len(a.pending_asks)
                           for a in ms.core.partition.applications.values())

        deadline = time.perf_counter() + deadline_s
        while pending() < n_pods:
            if time.perf_counter() > deadline:
                raise AssertionError(f"{pending()} of {n_pods} asks reached "
                                     "the core")
            time.sleep(0.02)
        cycles = []
        while not cycles or cycles[-1]:
            cycles.append(ms.core.schedule_once())
            if len(cycles) > 32:
                raise AssertionError(f"no quiet cycle: {cycles}")
        while ms.bind_stats().success_count < len(allocs):
            if time.perf_counter() > deadline:
                raise AssertionError(f"{ms.bind_stats().success_count} of "
                                     f"{len(allocs)} binds")
            time.sleep(0.02)
        check_tiers(ms.core, f"shim harness on {device}")
        check_fake_cluster(ms)
        return [(names[k], n) for k, n in allocs], cycles
    finally:
        ms.stop()


def phase_shim(dev, stats):
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    bench = shim_bench_shape(dev)
    t0 = time.perf_counter()
    best_nodes.launches = 0
    on_card, cycles = shim_harness(dev, SHIM_CUT_NODES, SHIM_CUT_PODS)
    launches = best_nodes.launches
    card_s = time.perf_counter() - t0
    stats.setdefault("best_nodes", {})["launches_shim"] = launches
    on_cpu, cpu_cycles = shim_harness(torch.device("cpu"), SHIM_CUT_NODES,
                                      SHIM_CUT_PODS)
    if on_card != on_cpu:
        diff = sum(a != b for a, b in zip(on_card, on_cpu))
        raise AssertionError(f"cuda and cpu shims allocate differently "
                             f"({diff} of {len(on_card)}; cycles {cycles} "
                             f"vs {cpu_cycles})")
    if (len(on_card), cycles) != EXPECTED_SHIM_CUT:
        raise AssertionError(f"placed {len(on_card)} in cycles {cycles}, the "
                             f"JAX package's {EXPECTED_SHIM_CUT}")
    if launches < 1:
        raise AssertionError("the shim's pressure run launched no "
                             "best_nodes kernel")
    return {"bench_shape": bench,
            "pressure_cut": {"nodes": SHIM_CUT_NODES, "pods": SHIM_CUT_PODS,
                             "placed": len(on_card), "cycles": cycles,
                             "identical_cuda_cpu": True,
                             "expected": list(EXPECTED_SHIM_CUT),
                             "best_nodes_launches": launches,
                             "card_run_s": card_s}}


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def rest_call(port, path, body=None, timeout=30):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else body.encode(),
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def scheduler_argv(*flags):
    """The command that starts the scheduler binary, as a user runs it."""
    return [sys.executable, "-m", "yunikorn_tpu_torch.cmd.scheduler",
            *flags]


def phase_cmd():
    """The scheduler binary as a user starts it, on the card."""
    import signal
    import tempfile

    port = free_port()
    tmp = tempfile.mkdtemp(prefix="yk-cmd-")
    trace_out = os.path.join(tmp, "cycles.json")
    log_path = os.path.join(tmp, "scheduler.log")
    env = dict(os.environ, YK_PROFILE_DIR=os.path.join(tmp, "profile"))
    argv = scheduler_argv("--nodes", str(CMD_NODES), "--rest-port", str(port),
                          "--trace-out", trace_out, "--pods", str(CMD_PODS))
    out = {"argv": argv[2:]}

    def wait(cond, what, timeout):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f"the scheduler exited "
                                     f"{proc.returncode} waiting for {what}")
            try:
                if cond():
                    return time.perf_counter()
            except OSError:
                pass
            time.sleep(0.1)
        raise AssertionError(f"timed out waiting for {what}")

    def bound():
        status, body = rest_call(port, "/ws/v1/apps")
        return sum(len(a["allocations"]) for a in json.loads(body).values())

    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env,
                                stdout=subprocess.DEVNULL, stderr=log)
        try:
            t_nodes = wait(lambda: len(json.loads(rest_call(
                port, "/ws/v1/nodes")[1])) == CMD_NODES,
                f"{CMD_NODES} nodes", 180)
            out["nodes_ready_s"] = t_nodes - t0
            status, start = rest_call(port, "/ws/v1/profile/start?name=cmd",
                                      "")
            if status != 200:
                raise AssertionError(f"profile start: {status} {start}")
            out["profile_start_s"] = time.perf_counter() - t_nodes
            out["bound_at_profile_start"] = bound()
            time.sleep(CMD_PROFILE_S)
            t_stop = time.perf_counter()
            status, stop = rest_call(port, "/ws/v1/profile/stop", "",
                                     timeout=180)
            out["profile_stop_s"] = time.perf_counter() - t_stop
            out["bound_at_profile_stop"] = bound()
            if status != 200:
                raise AssertionError(f"profile stop: {status} {stop}")
            trace = json.loads(stop)["trace"]
            events = json.load(open(trace))["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            if not kernels:
                raise AssertionError("the profile holds no CUDA kernel")
            t_bound = wait(lambda: bound() == CMD_PODS,
                           f"{CMD_PODS} pods bound", 180)
            out["all_bound_s"] = t_bound - t0
            status, metrics = rest_call(port, "/metrics")
            series = [ln for ln in metrics.splitlines()
                      if ln.startswith("yunikorn_cycle_stage_ms_count")]
            if status != 200 or not series:
                raise AssertionError("/metrics lacks the core's cycle series")
            proc.send_signal(signal.SIGTERM)
            t_term = time.perf_counter()
            rc = proc.wait(timeout=30)
            out.update({"bound": CMD_PODS, "profile_events": len(events),
                        "profile_kernels": len(kernels),
                        "profile_kernel_names": sorted(
                            {e["name"][:60] for e in kernels})[:8],
                        "metrics_cycle_series": series,
                        "exit_code": rc,
                        "exit_s": time.perf_counter() - t_term})
        except Exception as e:
            tail = open(log_path).read()[-1500:]
            raise AssertionError(f"{type(e).__name__}: {e}; the scheduler's "
                                 f"log ends: {tail}") from e
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    if out.get("exit_code") != 0:
        raise AssertionError(f"exit code {out.get('exit_code')}")
    cycles = json.load(open(trace_out))
    log_text = open(log_path).read()
    if "device=cuda" not in log_text:
        raise AssertionError("the scheduler's log does not name device=cuda")
    out.update({"trace_out_events": len(cycles["traceEvents"]),
                "log_device_line": next(ln for ln in log_text.splitlines()
                                        if "device=cuda" in ln)[-120:]})
    return out


def fake_apiserver():
    """tests/fake_apiserver.FakeAPIServer, started: (server, port)."""
    from yunikorn_tpu_torch.cmd.trace_replay import fake_apiserver_class

    server = fake_apiserver_class()()
    return server, server.start()


def metric_sums(families, name, by):
    """{label value: sample sum} of a parsed family's samples named
    `name`, keyed by the label `by`."""
    out = {}
    for fam in families.values():
        for sample in fam.samples:
            if sample.name == name:
                key = sample.labels.get(by, "")
                out[key] = out.get(key, 0.0) + sample.value
    return out


def write_kubeconfig(tmp, api_port) -> str:
    """A kubeconfig under tmp naming the fake API server on api_port."""
    kubeconfig = os.path.join(tmp, "kubeconfig")
    with open(kubeconfig, "w") as f:
        # JSON, which the kubeconfig loader's YAML parser reads
        json.dump({"apiVersion": "v1", "kind": "Config",
                   "current-context": "fake",
                   "clusters": [{"name": "fake", "cluster": {
                       "server": f"http://127.0.0.1:{api_port}"}}],
                   "contexts": [{"name": "fake", "context": {
                       "cluster": "fake", "user": "u"}}],
                   "users": [{"name": "u", "user": {}}]}, f)
    return kubeconfig


def phase_kube():
    """The scheduler binary with --kubeconfig, on the card, against the
    fake API server in this process: CMD_NODES nodes at the server before
    start, CMD_PODS sleep pods added in waves, the watches killed and the
    event log compacted once halfway (the reflectors reconnect, get 410 and
    relist). Every pod bound exactly once at the server, /metrics valid
    under the port's promtext with the reflectors' series, SIGTERM exits
    0."""
    import signal
    import tempfile

    from yunikorn_tpu_torch.obs.promtext import (parse_exposition,
                                                 validate_exposition)

    server, api_port = fake_apiserver()
    tmp = tempfile.mkdtemp(prefix="yk-kube-")
    kubeconfig = write_kubeconfig(tmp, api_port)
    for i in range(CMD_NODES):
        server.add_node_doc(f"kn-{i}")
    rest = free_port()
    argv = scheduler_argv("--kubeconfig", kubeconfig, "--rest-port",
                          str(rest))
    log_path = os.path.join(tmp, "scheduler.log")
    out = {"argv": argv[2:4] + ["<kubeconfig>"] + argv[5:]}

    def bound_names():
        return [n for n, _ in list(server.bindings)]

    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as log:
            proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.DEVNULL,
                                    stderr=log)
            try:
                def wait(cond, what, timeout, on_tick=None):
                    deadline = time.perf_counter() + timeout
                    while time.perf_counter() < deadline:
                        if proc.poll() is not None:
                            raise AssertionError(
                                f"the scheduler exited {proc.returncode} "
                                f"waiting for {what}")
                        try:
                            if cond():
                                return time.perf_counter()
                        except OSError:
                            pass
                        if on_tick is not None:
                            on_tick()
                        time.sleep(0.1)
                    raise AssertionError(f"timed out waiting for {what}")

                t_nodes = wait(lambda: len(json.loads(rest_call(
                    rest, "/ws/v1/nodes")[1])) == CMD_NODES,
                    f"{CMD_NODES} nodes", 180)
                out["nodes_ready_s"] = t_nodes - t0
                first_bind = []
                # when the core first held an app, an ask and an allocation,
                # and the dispatcher's backlog from its first allocation
                # until the server's first binding
                core_seen = {}
                backlog = []
                polled = [0.0]

                def read(path):
                    try:
                        status, body = rest_call(rest, path)
                    except OSError:
                        return None
                    return json.loads(body) if status == 200 else None

                def note_progress():
                    now = time.perf_counter()
                    if not first_bind and server.bindings:
                        first_bind.append(now)
                    if first_bind or now - polled[0] < KUBE_POLL_S:
                        return
                    polled[0] = now
                    if "alloc" in core_seen:
                        health = read("/ws/v1/health") or {}
                        d = health.get("components", {}).get("dispatcher")
                        if d is not None:
                            backlog.append((now - t_pods, d["buffered"]
                                            + d["overflow"]))
                        return
                    apps = read("/ws/v1/apps")
                    if apps is None:
                        return
                    apps = list(apps.values())
                    for key, seen in (
                            ("app", bool(apps)),
                            ("ask", any(a["pendingAsks"] or a["allocations"]
                                        for a in apps)),
                            ("alloc", any(a["allocations"] for a in apps))):
                        if seen:
                            core_seen.setdefault(key, now)

                added = 0
                disrupted = {}
                t_pods = time.perf_counter()
                while added < CMD_PODS:
                    for i in range(added, min(added + KUBE_WAVE, CMD_PODS)):
                        server.add_pod_doc(f"kp-{i}", app_id=f"kube-app-{i % 5}")
                    added = min(added + KUBE_WAVE, CMD_PODS)
                    if not disrupted and added >= CMD_PODS // 2:
                        # the reflectors' resume point falls out of the
                        # compacted log: each reconnect gets 410 and relists
                        server.compact()
                        disrupted = {"at_pods_added": added,
                                     "bound_then": len(server.bindings),
                                     "watches_killed": server.kill_watches()}
                    end = time.perf_counter() + KUBE_WAVE_GAP_S
                    while time.perf_counter() < end:
                        note_progress()
                        time.sleep(0.02)
                t_bound = wait(lambda: len(server.bindings) >= CMD_PODS,
                               f"{CMD_PODS} pods bound at the server", 240,
                               on_tick=note_progress)
                note_progress()
                time.sleep(1.0)  # a late duplicate bind would land here
                out["all_bound_s"] = t_bound - t0
                out["disruption"] = disrupted
                status, metrics = rest_call(rest, "/metrics")
                if status != 200:
                    raise AssertionError(f"/metrics: {status}")
                problems = validate_exposition(metrics)
                if problems:
                    raise AssertionError(f"/metrics invalid: {problems[:5]}")
                fams = parse_exposition(metrics)
                for fam in ("yunikorn_informer_restarts_total",
                            "yunikorn_informer_last_sync_age_seconds"):
                    if fam not in fams:
                        raise AssertionError(f"/metrics lacks {fam}")
                status, health = rest_call(rest, "/ws/v1/health")
                informers = json.loads(health).get("components", {}).get(
                    "informers", {})
                stage_sum = metric_sums(fams, "yunikorn_cycle_stage_ms_sum",
                                        "stage")
                stage_n = metric_sums(fams, "yunikorn_cycle_stage_ms_count",
                                      "stage")
                cold = metric_sums(fams, "yunikorn_cold_first_cycle_ms", "")
                status, snap = rest_call(rest, "/ws/v1/metrics")
                out["cold_split"] = (json.loads(snap).get("cold_split")
                                     if status == 200 else None)
                proc.send_signal(signal.SIGTERM)
                t_term = time.perf_counter()
                rc = proc.wait(timeout=30)
                out.update({
                    "exit_code": rc, "exit_s": time.perf_counter() - t_term,
                    "informer_restarts": sum(metric_sums(
                        fams, "yunikorn_informer_restarts_total",
                        "informer").values()),
                    "informer_health": {k: informers.get(k) for k in
                                        ("healthy", "restarts")},
                    "metrics_families": len(fams),
                    "cold_first_cycle_ms": cold.get(""),
                    "stage_mean_ms": {
                        k: stage_sum[k] / stage_n[k]
                        for k in sorted(stage_sum) if stage_n.get(k)},
                    "cycles": max(stage_n.values(), default=0)})
            except Exception as e:
                tail = open(log_path).read()[-1500:]
                raise AssertionError(f"{type(e).__name__}: {e}; the "
                                     f"scheduler's log ends: {tail}") from e
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=10)
        names = bound_names()
    finally:
        server.stop()
    if out.get("exit_code") != 0:
        raise AssertionError(f"exit code {out.get('exit_code')}")
    if not out.get("cold_split"):
        raise AssertionError("/ws/v1/metrics carries no cold_split")
    if len(names) != CMD_PODS or len(set(names)) != CMD_PODS:
        raise AssertionError(f"{len(names)} bindings of {len(set(names))} "
                             f"pods, want each of {CMD_PODS} once")
    log_text = open(log_path).read()
    if "device=cuda" not in log_text:
        raise AssertionError("the scheduler's log does not name device=cuda")
    out.update({"bound": len(names),
                **{f"first_{k}_at_core_after_first_pod_s": (
                    core_seen[k] - t_pods if k in core_seen else None)
                   for k in ("app", "ask", "alloc")},
                "first_bind_after_first_pod_s": (
                    first_bind[0] - t_pods if first_bind else None),
                # [s after the first pod, events queued] from the core's
                # first allocation until the first binding
                "dispatcher_backlog": backlog,
                "pods_added_s": t_pods - t0,
                "pods_per_s_first_to_last_bind": (
                    CMD_PODS / (t_bound - first_bind[0])
                    if first_bind and t_bound > first_bind[0] else None)})
    return out


def admission_argv(*flags):
    """The command that starts the admission controller binary, as a user
    runs it (host code: no device)."""
    return [sys.executable, "-m", "yunikorn_tpu_torch.cmd.admission_controller",
            *flags]


def apply_json_patch(doc, patch):
    """Apply an admission response's JSON patch (add / replace of object
    members, RFC 6902) to doc in place, as the API server does."""
    import copy

    for op in patch:
        if op["op"] not in ("add", "replace"):
            raise AssertionError(f"unexpected patch op {op}")
        keys = [k.replace("~1", "/").replace("~0", "~")
                for k in op["path"].lstrip("/").split("/")]
        target = doc
        for key in keys[:-1]:
            target = target.setdefault(key, {})
        if op["op"] == "replace" and keys[-1] not in target:
            raise AssertionError(f"replace of a missing member: {op}")
        target[keys[-1]] = copy.deepcopy(op["value"])


def admit_pod_doc(name, ns, priority_class=""):
    """A sleep pod as a user creates it: no schedulerName, no labels."""
    doc = {"metadata": {"name": name, "namespace": ns,
                        "creationTimestamp": "2026-01-01T00:00:00Z"},
           "spec": {"containers": [{"name": "sleep", "resources": {
               "requests": {"cpu": "500m", "memory": "128Mi"}}}]},
           "status": {"phase": "Pending"}}
    if priority_class:
        doc["spec"]["priorityClassName"] = priority_class
    return doc


def admit_review(doc, uid):
    """The AdmissionReview the API server sends for a pod's CREATE."""
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "kind": {"kind": "Pod"},
                        "namespace": doc["metadata"]["namespace"],
                        "operation": "CREATE", "userInfo": ADMIT_USER,
                        "object": doc}}


def admit_expected(ns, priority_class):
    """The (path, value) ops, in order, of the JSON patch the reference's
    controller writes for a bare pod of ADMIT_USER in a processed namespace
    ns (the port's own constants and default queue). With a priority class
    the allow-preemption annotation comes
    as a second op on /metadata/annotations that holds only it, after the
    user-info op: applied in order, it drops the user info (a fault of the
    reference kept by the port, ROADMAP §3)."""
    from yunikorn_tpu_torch.admission.conf import DEFAULT_QUEUE
    from yunikorn_tpu_torch.common import constants as c

    user_info = json.dumps({"user": ADMIT_USER["username"],
                            "groups": ADMIT_USER["groups"]})
    ops = [("/metadata/annotations", {c.ANNOTATION_USER_INFO: user_info}),
           ("/spec/schedulerName", c.SCHEDULER_NAME),
           ("/metadata/labels", {
               c.LABEL_APPLICATION_ID: f"yunikorn-{ns}-autogen",
               c.LABEL_QUEUE_NAME: DEFAULT_QUEUE})]
    if priority_class:
        ops.append(("/metadata/annotations",
                    {c.ANNOTATION_ALLOW_PREEMPTION: c.FALSE}))
    return ops


def admit_client(tls, bundle, port):
    """(base URL, SSL context) of the webhook: over TLS the context trusts
    the caBundle of the installed configurations and nothing else."""
    import ssl

    if not tls:
        return f"http://127.0.0.1:{port}", None
    return (f"https://localhost:{port}",
            ssl.create_default_context(cadata=bundle))


def admit_call(base, ctx, path, doc=None, timeout=30):
    """GET path of the webhook, or POST doc there; the decoded reply."""
    import urllib.request

    req = urllib.request.Request(
        base + path, data=None if doc is None else json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout, context=ctx) as r:
        return json.loads(r.read())


def phase_admit():
    """The admission webhook in front of the scheduler on the card: the
    port's admission controller binary and scheduler binary, both with
    --kubeconfig against the fake API server in this process; this process
    plays the API server's admission step (POST /mutate, apply the patch,
    create the pod). Bare pods are patched, bound once by the scheduler
    under the applicationId their patch gave them; the excluded namespace
    is patched only after the configmap's hot reload; a configmap is
    validated through the controller's seam to the scheduler's REST;
    webtest proxies the REST; both binaries exit 0 on SIGTERM."""
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from yunikorn_tpu_torch.admission.admission_controller import (
        AdmissionController, decode_patch)
    from yunikorn_tpu_torch.admission.conf import AdmissionConf
    from yunikorn_tpu_torch.common import constants as c
    from yunikorn_tpu_torch.webapp.webtest import WebTestServer

    try:
        import cryptography  # noqa: F401
        tls, tls_error = True, None
    except ImportError as e:
        tls, tls_error = False, f"{type(e).__name__}: {e}"
    out = {"tls": tls, **({"tls_error": tls_error} if not tls else {})}
    server, api_port = fake_apiserver()
    tmp = tempfile.mkdtemp(prefix="yk-admit-")
    kubeconfig = write_kubeconfig(tmp, api_port)
    for ns in ("yunikorn",) + ADMIT_NAMESPACES:
        server.add("namespaces", {"metadata": {"name": ns}})
    configmap = {"metadata": {"name": c.CONFIGMAP_NAME,
                              "namespace": "yunikorn"},
                 "data": {"admissionController.filtering.processNamespaces":
                          ADMIT_PROCESS}}
    server.add("configmaps", configmap)
    server.add("priorityclasses", {
        "metadata": {"name": ADMIT_PRIORITY_CLASS, "annotations": {
            c.ANNOTATION_ALLOW_PREEMPTION: c.FALSE}}, "value": 100})
    for i in range(CMD_NODES):
        server.add_node_doc(f"an-{i}")
    hook_port, rest = free_port(), free_port()
    procs = {}
    logs = {name: os.path.join(tmp, f"{name}.log")
            for name in ("admission", "scheduler")}
    argvs = {"admission": admission_argv(
                 "--kubeconfig", kubeconfig, "--host", "localhost",
                 "--port", str(hook_port), *(() if tls else ("--no-tls",))),
             "scheduler": scheduler_argv("--kubeconfig", kubeconfig,
                                         "--rest-port", str(rest))}
    out["argv"] = {k: [a if a != kubeconfig else "<kubeconfig>"
                       for a in v[2:]] for k, v in argvs.items()}
    webhook_name = "yunikorn-admission-controller-cfg"
    patches = {}
    ms = []
    bound_at = []

    def note_binds():
        if not bound_at and server.bindings:
            bound_at.append(time.perf_counter())

    def wait(cond, what, timeout):
        deadline = time.perf_counter() + timeout
        last = None
        while time.perf_counter() < deadline:
            note_binds()
            for name, proc in procs.items():
                if proc.poll() is not None:
                    raise AssertionError(f"the {name} binary exited "
                                         f"{proc.returncode} waiting for "
                                         f"{what}")
            try:
                if cond():
                    return time.perf_counter()
            except OSError as e:
                last = e
            time.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}" + (
            f" (last error: {type(last).__name__}: {last})" if last else ""))

    def admit(name, ns, priority_class, base, ctx):
        doc = admit_pod_doc(name, ns, priority_class)
        t0 = time.perf_counter()
        resp = admit_call(base, ctx, "/mutate",
                          admit_review(doc, f"uid-{name}"))
        ms.append((time.perf_counter() - t0) * 1e3)
        if resp["response"]["uid"] != f"uid-{name}" or \
                not resp["response"]["allowed"]:
            raise AssertionError(f"{name}: not allowed: {resp['response']}")
        patch = decode_patch(resp)
        patches[name] = (ns, priority_class, patch)
        apply_json_patch(doc, patch)
        server.add("pods", doc)

    def wave(names, base, ctx):
        with ThreadPoolExecutor(ADMIT_THREADS) as pool:
            futures = [pool.submit(admit, name, ns, pc, base, ctx)
                       for name, ns, pc in names]
            while not all(f.done() for f in futures):
                note_binds()
                time.sleep(0.01)
            for f in futures:
                f.result()

    def probe(ns, base, ctx, priority_class=""):
        """{path: value} of a probe pod's patch (the pod is not created)."""
        resp = admit_call(base, ctx, "/mutate", admit_review(
            admit_pod_doc("probe", ns, priority_class), "uid-probe"))
        return {p["path"]: p["value"] for p in decode_patch(resp)}

    try:
        for name in ("admission", "scheduler"):
            with open(logs[name], "w") as log:
                procs[name] = subprocess.Popen(
                    argvs[name], cwd=ROOT, stdout=subprocess.DEVNULL,
                    stderr=log)
        t0 = time.perf_counter()
        try:
            bundle = None
            if tls:
                wait(lambda: all(webhook_name in server.store[k] for k in (
                    "mutatingwebhookconfigurations",
                    "validatingwebhookconfigurations")),
                    "the webhook configurations", 60)
                hooks = {k: server.store[k][webhook_name]["webhooks"][0]
                         for k in ("mutatingwebhookconfigurations",
                                   "validatingwebhookconfigurations")}
                bundles = {h["clientConfig"]["caBundle"]
                           for h in hooks.values()}
                if len(bundles) != 1:
                    raise AssertionError("the two configurations carry "
                                         "different caBundles")
                bundle = bundles.pop()
                out["webhooks"] = {
                    k: {"path": h["clientConfig"]["service"]["path"],
                        "failurePolicy": h["failurePolicy"]}
                    for k, h in hooks.items()}
                out["ca_bundle_certs"] = bundle.count("BEGIN CERTIFICATE")
            base, ctx = admit_client(tls, bundle, hook_port)
            # over TLS this read verifies the server certificate against
            # the installed caBundle, the context's only CA
            wait(lambda: admit_call(base, ctx, "/health", timeout=5)
                 == {"status": "ok"}, "the webhook's /health", 60)
            # the controller's informers have the configmap (the excluded
            # namespace is not processed) and the priority class
            wait(lambda: "/spec/schedulerName" not in probe(
                ADMIT_NAMESPACES[-1], base, ctx)
                and c.ANNOTATION_ALLOW_PREEMPTION in probe(
                    ADMIT_NAMESPACES[0], base, ctx, ADMIT_PRIORITY_CLASS).get(
                    "/metadata/annotations", {}),
                "the admission informers", 60)
            out["webhook_ready_s"] = time.perf_counter() - t0
            wait(lambda: len(json.loads(rest_call(
                rest, "/ws/v1/nodes")[1])) == CMD_NODES,
                f"{CMD_NODES} nodes at the scheduler", 180)
            out["scheduler_ready_s"] = time.perf_counter() - t0
            first = [(f"ad-{i}", ns,
                      ADMIT_PRIORITY_CLASS if i % ADMIT_PC_EVERY == 1
                      and ns != ADMIT_NAMESPACES[-1] else "")
                     for i in range(ADMIT_PODS)
                     for ns in [ADMIT_NAMESPACES[i % len(ADMIT_NAMESPACES)]]]
            t_admit = time.perf_counter()
            wave(first, base, ctx)
            out["wave_s"] = time.perf_counter() - t_admit
            # hot reload: the configmap at the server now processes the
            # excluded namespace; the controller's informer feeds its conf
            configmap["data"] = {
                "admissionController.filtering.processNamespaces":
                    ADMIT_PROCESS_RELOADED}
            t_cm = time.perf_counter()
            server.add("configmaps", configmap)
            wait(lambda: "/spec/schedulerName" in probe(
                ADMIT_NAMESPACES[-1], base, ctx), "the conf's hot reload", 60)
            out["reload_s"] = time.perf_counter() - t_cm
            wave([(f"ad-r{i}", ADMIT_NAMESPACES[-1], "")
                  for i in range(ADMIT_RELOAD_PODS)], base, ctx)
            # the patch of every pod against what the reference writes
            patched, excluded = set(), set()
            for name, (ns, pc, patch) in patches.items():
                got = [(p["path"], p["value"]) for p in patch]
                if ns == ADMIT_NAMESPACES[-1] and not name.startswith("ad-r"):
                    if got != admit_expected(ns, "")[:1]:
                        raise AssertionError(f"{name} (excluded) patched: "
                                             f"{got}")
                    excluded.add(name)
                    continue
                if got != admit_expected(ns, pc):
                    raise AssertionError(f"{name}: patch {got}")
                patched.add(name)
            # the seam: validate_conf_fn POSTs queues.yaml to the
            # scheduler's /ws/v1/validate-conf
            def via_rest(queues_yaml):
                status, body = rest_call(rest, "/ws/v1/validate-conf",
                                         queues_yaml)
                if status != 200:
                    raise AssertionError(f"validate-conf: {status} {body}")
                answer = json.loads(body)
                return answer["allowed"], answer["reason"]

            seam = AdmissionController(AdmissionConf(),
                                       validate_conf_fn=via_rest)
            answers = {}
            for which, text in (("invalid", ADMIT_INVALID_QUEUES),
                                ("valid", ADMIT_VALID_QUEUES)):
                review = {"apiVersion": "admission.k8s.io/v1",
                          "kind": "AdmissionReview",
                          "request": {"uid": f"cm-{which}",
                                      "kind": {"kind": "ConfigMap"},
                                      "operation": "UPDATE",
                                      "object": {"metadata": {
                                          "name": c.CONFIGMAP_NAME,
                                          "namespace": "yunikorn"},
                                          "data": {"queues.yaml": text}}}}
                for where, resp in (
                        ("seam", seam.validate_conf(review)),
                        ("binary", admit_call(base, ctx, "/validate-conf",
                                              review))):
                    r = resp["response"]
                    answers[f"{where}_{which}"] = {
                        "allowed": r["allowed"],
                        "message": (r.get("result") or {}).get("message")}
            out["validate_conf"] = answers
            if answers["seam_invalid"]["allowed"] or \
                    not answers["seam_valid"]["allowed"]:
                raise AssertionError(f"the seam's answers: {answers}")
            if not (answers["binary_invalid"]["allowed"]
                    and answers["binary_valid"]["allowed"]):
                raise AssertionError(f"the binary's /validate-conf (no "
                                     f"validator, as the reference's): "
                                     f"{answers}")
            t_bound = wait(lambda: len(server.bindings) >= len(patched),
                           f"{len(patched)} binds", 240)
            time.sleep(1.0)  # a late duplicate or excluded bind lands here
            names = [n for n, _ in list(server.bindings)]
            if sorted(names) != sorted(patched):
                raise AssertionError(
                    f"{len(names)} bindings of {len(set(names))} pods, want "
                    f"each of {len(patched)} patched pods once; excluded "
                    f"bound: {sorted(set(names) & excluded)[:5]}")
            # each allocation under the applicationId its patch gave it
            uid_name = {doc["metadata"]["uid"]: doc["metadata"]["name"]
                        for doc in list(server.store["pods"].values())}
            status, body = rest_call(rest, "/ws/v1/apps")
            app_of = {}
            for app_id, app in json.loads(body).items():
                for key in app["allocations"]:
                    app_of[uid_name.get(key, key)] = app_id
            wrong = [n for n in patched if app_of.get(n) !=
                     f"yunikorn-{patches[n][0]}-autogen"]
            if wrong:
                raise AssertionError(f"{len(wrong)} pods not allocated under "
                                     f"their patched applicationId, e.g. "
                                     f"{wrong[:3]} -> "
                                     f"{[app_of.get(n) for n in wrong[:3]]}")
            # webtest in front of the scheduler's REST
            web = WebTestServer(tmp, f"http://127.0.0.1:{rest}", port=0)
            web_port = web.start()
            try:
                for path in ("/ws/v1/apps", "/ws/v1/nodes"):
                    direct = json.loads(rest_call(rest, path)[1])
                    status, proxied = rest_call(web_port, path)
                    if status != 200 or json.loads(proxied) != direct:
                        raise AssertionError(f"webtest {path}: {status}")
            finally:
                web.stop()
            exits = {}
            for name in ("admission", "scheduler"):
                procs[name].send_signal(signal.SIGTERM)
                t_term = time.perf_counter()
                exits[name] = {"exit_code": procs[name].wait(timeout=30),
                               "exit_s": time.perf_counter() - t_term}
            out["exits"] = exits
            bad = {k: v for k, v in exits.items() if v["exit_code"] != 0}
            if bad:
                raise AssertionError(f"exit codes {bad}")
        except Exception as e:
            tails = {name: open(path).read()[-1200:]
                     for name, path in logs.items() if os.path.exists(path)}
            raise AssertionError(f"{type(e).__name__}: {e}; the logs end: "
                                 f"{tails}") from e
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=10)
    finally:
        server.stop()
    log_text = open(logs["scheduler"]).read()
    if "device=cuda" not in log_text:
        raise AssertionError("the scheduler's log does not name device=cuda")
    ms.sort()
    out.update({
        "pods": len(patches), "patched": len(patched),
        "excluded_unpatched": len(excluded),
        "priority_class_pods": sum(1 for _, pc, _ in patches.values() if pc),
        "bound": len(patched), "apps": sorted(set(app_of.values())),
        "mutate_ms_p50": ms[len(ms) // 2],
        "mutate_ms_p99": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
        "mutate_ms_max": ms[-1],
        "first_bind_after_first_admission_s": bound_at[0] - t_admit,
        "pods_per_s_first_admission_to_last_bind":
            len(patched) / (t_bound - t_admit),
        "webtest": "proxied /ws/v1/apps and /ws/v1/nodes equal"})
    return out


def check_shard_part(got, ref, inp):
    """Hold the kernel's shard part (keys, nf, partial) against the plain
    version's on the same inputs: nf equal, the slice sums of the active
    rows equal bit for bit (both add the nodes in order in float64), and
    the keys equal except on near-ties, counted: a key may differ only
    where the plain version's top two scores u over the shard's nodes lie
    within LEARNED_NEAR_TIE (the Gumbel noise's logf is the device's).
    Raises on anything else; returns the counts."""
    from yunikorn_tpu_torch.ops.learned import chunk_scores
    from yunikorn_tpu_torch.utils import prng

    keys, nf, partial = got
    rkeys, rnf, rpartial = ref
    if not torch.equal(nf, rnf):
        raise AssertionError(f"nf differs on {int((nf != rnf).sum())} rows")
    act = inp["active"]
    if not torch.equal(partial[act], rpartial[act]):
        diff = float((partial[act] - rpartial[act]).abs().max())
        raise AssertionError(f"slice sums differ by up to {diff}")
    bad = (keys != rkeys).nonzero().squeeze(1).tolist()
    chunk = inp["chunk"]
    round_key = prng.fold_in(inp["key"], inp["rnd"])
    ties = 0
    for c in sorted({i // chunk for i in bad}):
        _ok, _ls, u = chunk_scores(inp["pod_emb"], inp["node_emb"],
                                   inp["group_id"], inp["group_feas"],
                                   inp["free"], inp["req"], inp["tau"],
                                   round_key, c, chunk,
                                   inp.get("node_offset", 0),
                                   inp.get("m_total"))
        for i in [i for i in bad if i // chunk == c]:
            top2 = u[i - c * chunk].topk(2).values
            if float(top2[0] - top2[1]) > LEARNED_NEAR_TIE:
                raise AssertionError(f"row {i}: key differs off a near-tie")
            ties += 1
    return {"rows": int(nf.numel()), "pick_near_ties": ties}


def hold_learned_calls(captured, where):
    """Each captured learned_propose shard call again through the kernel
    and its plain version (check_shard_part), and each finish call at its
    captured merged slots, whose four outputs must equal the plain
    version's bit for bit; returns the counts, the summed near-ties of the
    shard calls' picks and the largest |lmean - plain lmean| measured over
    the finishes (None when nothing was captured)."""
    from yunikorn_tpu_torch.ops.learned import (
        learned_propose_finish, learned_propose_finish_reference,
        learned_propose_shard, learned_propose_shard_reference)

    out = {"calls": len(captured["shard"]),
           "finish_calls": len(captured["finish"]), "pick_near_ties": 0,
           "lmean_max_abs_err": None}
    for inp in captured["shard"]:
        try:
            check = check_shard_part(learned_propose_shard(**inp),
                                     learned_propose_shard_reference(**inp),
                                     inp)
        except AssertionError as e:
            raise AssertionError(f"learned_propose at {where}, shard offset "
                                 f"{inp.get('node_offset', 0)}: {e}") from e
        out["pick_near_ties"] += check["pick_near_ties"]
    for inp in captured["finish"]:
        got = learned_propose_finish(**inp)
        ref = learned_propose_finish_reference(**inp)
        err = float((got[3] - ref[3]).abs().max()) if got[3].numel() else 0.0
        out["lmean_max_abs_err"] = max(out["lmean_max_abs_err"] or 0.0, err)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"learned_propose_finish at {where} "
                                 "differs from its plain version")
    return out


def replay_run(argv, policy, dev, run, stats):
    """One run_replay of trace_replay's command line `argv` under `policy`
    on `dev`, with both kernels' launch counts set to 0 just before it and
    read just after, and every call of each captured and then held against
    its plain version. Folds best_nodes' launches into the kernels line as
    launches_replay_<run>, its held calls as held_replay_calls and their
    largest error as max_abs_err_replay (None until a call was held).
    Returns (report, launches, held)."""
    from yunikorn_tpu_torch.cmd import trace_replay
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes
    from yunikorn_tpu_torch.ops.learned import learned_propose

    where = f"the {run} replay"
    args = trace_replay.build_parser().parse_args(argv)
    with capturing_best_nodes() as bn_calls, \
            capturing_learned_propose() as lp_calls:
        torch.cuda.synchronize()
        best_nodes.launches = 0
        learned_propose.launches = 0
        report = trace_replay.run_replay(args, policy, device=dev)
        torch.cuda.synchronize()
        launches = {"best_nodes": best_nodes.launches,
                    "learned_propose": learned_propose.launches}
    if len(bn_calls) != launches["best_nodes"]:
        raise AssertionError(f"{where}: {launches['best_nodes']} best_nodes "
                             f"launches but {len(bn_calls)} calls captured")
    held = {"best_nodes_calls": len(bn_calls),
            "best_nodes_max_abs_err": hold_calls(bn_calls, where),
            "learned_propose": hold_learned_calls(lp_calls, where)}
    bn = stats.setdefault("best_nodes", {})
    bn[f"launches_replay_{run}"] = launches["best_nodes"]
    bn["held_replay_calls"] = (bn.get("held_replay_calls", 0)
                               + held["best_nodes_calls"])
    errs = [e for e in (bn.get("max_abs_err_replay"),
                        held["best_nodes_max_abs_err"]) if e is not None]
    bn["max_abs_err_replay"] = max(errs, default=None)
    return report, launches, held


def replay_summary(report):
    fp = report["fingerprint"]
    t = report["timings"]
    e2e = report["slo"]["objectives"]["pod_e2e_p99"]
    return {"pass": report["pass"], "bound": fp["bound"],
            "created": fp["created"], "all_bound": fp["all_bound"],
            "verdicts": fp["verdicts"],
            "violated": fp["violated_objectives"],
            "policy_duels": t.get("policy_duels"),
            "e2e_p99_s": e2e["value"],
            **{k: t.get(k) for k in ("warmup_s", "cold_first_cycle_ms",
                                     "trace_s", "drain_s", "wall_s")}}


def replay_passed(report, what, out):
    """Raises unless the replay passed with its five verdicts ok and every
    pod bound."""
    fp = report["fingerprint"]
    if not (report["pass"] and fp["all_bound"]
            and set(fp["verdicts"].values()) == {"ok"}
            and len(fp["verdicts"]) == 5):
        raise AssertionError(f"{what} did not pass: {json.dumps(out)[:1500]}")


def replay_storm(dev, stats):
    """(A) gang-storm at the JAX replay's acceptance shape: every verdict
    ok, every pod bound."""
    report, launches, held = replay_run(REPLAY_STORM, "auto", dev, "storm",
                                        stats)
    out = {"fingerprint": report["fingerprint"],
           **replay_summary(report), "launches": launches, "held": held}
    replay_passed(report, "gang-storm at 10,000 nodes", out)
    return out


def replay_contention(dev, stats):
    """(D) gang-storm under contention (REPLAY_CONTENTION): the third
    storm outgrows the fleet until the second storm's completions free
    room, so cycles leave pods for the odd rounds, which call best_nodes.
    Every verdict ok, every pod bound, best_nodes launched and every call
    held."""
    report, launches, held = replay_run(REPLAY_CONTENTION, "auto", dev,
                                        "contention", stats)
    out = {**replay_summary(report), "launches": launches, "held": held}
    replay_passed(report, "the contended gang-storm", out)
    if launches["best_nodes"] < 1:
        raise AssertionError("best_nodes never launched in the contended "
                             "replay")
    return out


def replay_policy(dev, stats):
    """(B) the policy round trip: record a slice-fragmentation replay's
    duels under solver.policy=optimal, fit a checkpoint on the card with
    the port's trainer command, then replay the same trace per arm (greedy,
    optimal, learned with the new checkpoint). The dataset holds a cycle,
    the learned arm binds no fewer pods than greedy and launches
    learned_propose, and every kernel call is held. (best_nodes' launches
    are counted but not required: at this shape every pod places in the
    water fill's round 0, before an odd round calls it; D is the replay
    that launches it.)"""
    import tempfile

    from yunikorn_tpu_torch.policy.train import load_dataset

    tmp = tempfile.mkdtemp(prefix="yk-policy-")
    ds = os.path.join(tmp, "dataset")
    prefix = os.path.join(tmp, "ckpt")
    report, launches, held = replay_run(
        REPLAY_POLICY + ["--dataset-out", ds], "optimal", dev, "record", stats)
    cycles = len(load_dataset(ds))
    out = {"record": {**replay_summary(report), "cycles": cycles,
                      "launches": launches, "held": held}}
    if cycles < 1:
        raise AssertionError("the recording replay wrote no duel cycle")
    t0 = time.perf_counter()
    fit = subprocess.run(
        [sys.executable, "-m", "yunikorn_tpu_torch.cmd.policy_train",
         "--dataset", ds, "--out", prefix,
         "--imitation-epochs", str(POLICY_FIT_EPOCHS[0]),
         "--finetune-epochs", str(POLICY_FIT_EPOCHS[1]),
         "--device", dev.type],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if fit.returncode != 0:
        raise AssertionError(f"policy_train exited {fit.returncode}: "
                             f"{fit.stderr[-1500:]}")
    fitted = json.loads(fit.stdout)
    losses = fitted["losses"]
    out["fit"] = {"seconds": time.perf_counter() - t0,
                  "hash": fitted["hash"], "cycles": fitted["cycles"],
                  "winners": fitted["winners"],
                  "imitation_loss": [losses["imitation"][0],
                                     losses["imitation"][-1]],
                  "finetune_loss": [losses["finetune"][0],
                                    losses["finetune"][-1]]}
    arms = {}
    for policy in ("greedy", "optimal", "learned"):
        report, launches, held = replay_run(
            REPLAY_POLICY + ["--policy-checkpoint", prefix], policy, dev,
            policy, stats)
        arms[policy] = {**replay_summary(report),
                        "checkpoint": report["fingerprint"][
                            "policy_checkpoint"],
                        "launches": launches, "held": held}
    out["arms"] = arms
    learned = arms["learned"]
    lp = stats.setdefault("learned_propose", {})
    lp["launches_replay_learned"] = learned["launches"]["learned_propose"]
    lp["lmean_max_abs_err_replay"] = learned["held"]["learned_propose"][
        "lmean_max_abs_err"]
    if learned["bound"] < arms["greedy"]["bound"]:
        raise AssertionError(f"the learned arm bound {learned['bound']} < "
                             f"greedy's {arms['greedy']['bound']}")
    if learned["launches"]["learned_propose"] < 1:
        raise AssertionError("learned_propose never launched in the learned "
                             "arm")
    if learned["checkpoint"] != fitted["hash"]:
        raise AssertionError(f"the learned arm served {learned['checkpoint']}"
                             f", not the fit's {fitted['hash']}")
    return out


def replay_takeover(dev, stats):
    """(C) restart-storm with a fresh-process takeover (no store): the
    child recovers every bound pod, loses none and evicts none."""
    report, launches, held = replay_run(REPLAY_TAKEOVER_COLD, "auto", dev,
                                        "takeover", stats)
    proc = report["fingerprint"]["process_restart"] or {}
    out = {**replay_summary(report), "process_restart": proc,
           "takeover": report["timings"].get("takeover"),
           "restart_first_cycle_ms": report["timings"].get(
               "restart_first_cycle_ms"),
           "launches": launches, "held": held}
    if not (proc.get("restored_all") and proc.get("lost_bound") == 0
            and proc.get("mis_evictions") == 0):
        raise AssertionError(f"the takeover failed: {json.dumps(out)[:1500]}")
    return out


def phase_replay(dev, stats):
    """The port's trace-replay driver on the card: (A) gang-storm at
    10,000 nodes, (B) the policy round trip, (C) the fresh-process
    takeover, (D) gang-storm under contention."""
    return {"storm": replay_storm(dev, stats),
            "policy": replay_policy(dev, stats),
            "takeover": replay_takeover(dev, stats),
            "contention": replay_contention(dev, stats)}


def warm_smoke(dev, store, stats):
    """cmd/aot_smoke's three fresh children on `store` (empty) at
    WARM_BUCKET: the cold child builds every kernel and stores it, the hit
    and prewarm children count a hit per kernel and build nothing, all three
    place identically, the prewarm child's first cycle is within
    WARM_MAX_RATIO of the median of its warm cycles of new pods, and every
    prewarm kernel call equals its plain version (aot_smoke's bars; the
    ratio against the JAX smoke's re-submitted warm cycles is reported). Folds the prewarm child's
    launches and held calls into the kernels line."""
    from yunikorn_tpu_torch.cmd import aot_smoke

    args = aot_smoke.build_parser().parse_args(
        ["--bucket", WARM_BUCKET, "--store", store,
         "--max-ratio", str(WARM_MAX_RATIO)])
    res = aot_smoke.run_smoke(args, dev)
    children = {
        w: {k: c.get(k) for k in (
            "first_cycle_ms", "warm_ms", "warm_median_ms", "ref_warm_ms",
            "ref_warm_median_ms", "aot_hits",
            "aot_misses", "compile_count", "placed", "placements_digest",
            "launches", "held", "cold_split", "prewarm", "process_s")}
        for w, c in res["children"].items()}
    out = {"children": children,
           "prewarm_first_vs_warm": res["prewarm_first_vs_warm"],
           "prewarm_first_vs_ref_warm": res["prewarm_first_vs_ref_warm"],
           "placement_identical": res["placement_identical"],
           "prewarm_held_calls": res["prewarm_held_calls"],
           "prewarm_max_abs_err": res["prewarm_max_abs_err"]}
    if res["failures"]:
        raise AssertionError(f"aot_smoke: {res['failures']}; "
                             f"{json.dumps(out)[:2500]}")
    pre = res["children"]["prewarm"]
    for name in ("best_nodes", "learned_propose"):
        k = stats.setdefault(name, {})
        k["launches_warm"] = pre["launches"][name]
        k["held_warm_calls"] = pre["held"][f"{name}_calls"]
    stats["best_nodes"]["max_abs_err_warm"] = res["prewarm_max_abs_err"]
    return out


def warm_kube(store):
    """The binary as the kube phase starts it, with --aot-store (the warm
    phase's store) and --prewarm WARM_KUBE_BUCKET: CMD_NODES nodes at the
    server before start, and once they are at REST and the prewarm is done
    (its log line), one wave of KUBE_WAVE pods (no watch kill). Every pod
    bound once, the store's hits at /metrics with no nvcc build, the first
    cycle (cold_first_cycle_ms and its cold_split at /ws/v1/metrics) and the
    first bind after the first pod, SIGTERM exits 0."""
    import signal
    import tempfile

    from yunikorn_tpu_torch.obs.promtext import parse_exposition

    server, api_port = fake_apiserver()
    tmp = tempfile.mkdtemp(prefix="yk-warm-kube-")
    kubeconfig = write_kubeconfig(tmp, api_port)
    for i in range(CMD_NODES):
        server.add_node_doc(f"kn-{i}")
    rest = free_port()
    argv = scheduler_argv("--kubeconfig", kubeconfig, "--rest-port",
                          str(rest), "--aot-store", store, "--prewarm",
                          WARM_KUBE_BUCKET)
    log_path = os.path.join(tmp, "scheduler.log")
    out = {}
    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as log:
            proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.DEVNULL,
                                    stderr=log)
            try:
                def wait(cond, what, timeout):
                    deadline = time.perf_counter() + timeout
                    while time.perf_counter() < deadline:
                        if proc.poll() is not None:
                            raise AssertionError(
                                f"the scheduler exited {proc.returncode} "
                                f"waiting for {what}")
                        try:
                            if cond():
                                return time.perf_counter()
                        except OSError:
                            pass
                        time.sleep(0.05)
                    raise AssertionError(f"timed out waiting for {what}")

                out["nodes_ready_s"] = wait(lambda: len(json.loads(rest_call(
                    rest, "/ws/v1/nodes")[1])) == CMD_NODES,
                    f"{CMD_NODES} nodes", 180) - t0
                done = f"prewarm of bucket {WARM_KUBE_BUCKET} done"
                out["prewarm_done_s"] = wait(
                    lambda: done in open(log_path).read(), "the prewarm",
                    120) - t0
                t_pods = time.perf_counter()
                for i in range(KUBE_WAVE):
                    server.add_pod_doc(f"wp-{i}", app_id=f"warm-app-{i % 5}")
                t_first = wait(lambda: len(server.bindings) >= 1,
                               "the first binding", 120)
                t_all = wait(lambda: len(server.bindings) >= KUBE_WAVE,
                             f"{KUBE_WAVE} pods bound", 120)
                time.sleep(1.0)  # a late duplicate bind would land here
                out.update({"first_bind_after_first_pod_s": t_first - t_pods,
                            "all_bound_after_first_pod_s": t_all - t_pods})
                status, metrics = rest_call(rest, "/metrics")
                fams = parse_exposition(metrics)
                status, snap = rest_call(rest, "/ws/v1/metrics")
                snap = json.loads(snap)
                out.update({
                    "cold_first_cycle_ms": metric_sums(
                        fams, "yunikorn_cold_first_cycle_ms", "").get(""),
                    "aot_store_hits": metric_sums(
                        fams, "yunikorn_aot_store_hits_total", "").get(""),
                    "aot_store_misses": sum(metric_sums(
                        fams, "yunikorn_aot_store_misses_total",
                        "path").values()),
                    "cold_split": snap.get("cold_split")})
                proc.send_signal(signal.SIGTERM)
                t_term = time.perf_counter()
                out["exit_code"] = proc.wait(timeout=30)
                out["exit_s"] = time.perf_counter() - t_term
            except Exception as e:
                tail = open(log_path).read()[-1500:]
                raise AssertionError(f"{type(e).__name__}: {e}; the "
                                     f"scheduler's log ends: {tail}") from e
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=10)
        names = [n for n, _ in list(server.bindings)]
    finally:
        server.stop()
    if out.get("exit_code") != 0:
        raise AssertionError(f"exit code {out.get('exit_code')}")
    if len(names) != KUBE_WAVE or len(set(names)) != KUBE_WAVE:
        raise AssertionError(f"{len(names)} bindings of {len(set(names))} "
                             f"pods, want each of {KUBE_WAVE} once")
    cold = out["cold_split"] or {}
    if out["aot_store_hits"] != len(KERNELS) or out["aot_store_misses"]:
        raise AssertionError(f"the binary's store: {out['aot_store_hits']} "
                             f"hits, {out['aot_store_misses']} misses")
    if cold.get("builds") != 0:
        raise AssertionError(f"the binary's first cycle: {cold}")
    return out


def warm_takeover(dev, store, stats):
    """Replay C with --aot-store on the warm phase's store, and the bucket
    prewarm: the fresh-process child counts a store hit per kernel, builds
    nothing, its cold verdict ok, every bound pod restored, none lost."""
    report, launches, held = replay_run(
        REPLAY_TAKEOVER + ["--aot-store", store], "auto", dev,
        "takeover_store", stats)
    proc = report["fingerprint"]["process_restart"] or {}
    tk = report["timings"].get("takeover") or {}
    out = {**replay_summary(report), "process_restart": proc,
           "takeover": tk, "prewarm_s": report["timings"].get("prewarm"),
           "launches": launches, "held": held}
    if not (proc.get("restored_all") and proc.get("lost_bound") == 0
            and proc.get("mis_evictions") == 0
            and proc.get("cold_verdict") == "ok"):
        raise AssertionError(f"the takeover failed: {json.dumps(out)[:1500]}")
    if (tk.get("aot_hits"), tk.get("aot_builds")) != (len(KERNELS), 0):
        raise AssertionError(f"the takeover child: {tk.get('aot_hits')} "
                             f"hits, {tk.get('aot_builds')} builds")
    if (tk.get("restored_allocations") != tk.get("bound_at_boot")
            or not tk.get("bound_at_boot")):
        raise AssertionError(f"the takeover restored "
                             f"{tk.get('restored_allocations')} of "
                             f"{tk.get('bound_at_boot')}")
    if report["timings"].get("prewarm") is None:
        raise AssertionError("the replay ran no bucket prewarm")
    return out


def phase_warm(dev, stats):
    """The warm-start layer on the card, on one store the phase builds:
    cmd/aot_smoke's children, the binary with --aot-store and --prewarm,
    and replay C's takeover on the store."""
    import tempfile

    store = os.path.join(tempfile.mkdtemp(prefix="yk-warm-"), "store")
    out, failed = {}, []
    # each part runs (and reports) whatever an earlier one did; the phase
    # fails if any did
    for name, fn in (("smoke", lambda: warm_smoke(dev, store, stats)),
                     ("kube", lambda: warm_kube(store)),
                     ("takeover", lambda: warm_takeover(dev, store, stats))):
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"error": f"{type(e).__name__}: {e}"}
            failed.append(name)
    if failed:
        raise AssertionError(f"warm parts {failed} failed: "
                             f"{json.dumps(out, default=str)[:6000]}")
    return out


class CountingCallback:
    """scripts/shard_bench.py's callback: every placement by allocation
    key, and when the last one landed."""

    def __init__(self):
        import threading

        self.mu = threading.Lock()
        self.placed = {}
        self.last_place_at = time.perf_counter()

    def update_allocation(self, response):
        if response.new:
            with self.mu:
                for a in response.new:
                    self.placed[a.allocation_key] = a
                self.last_place_at = time.perf_counter()

    def update_application(self, response):
        pass

    def update_node(self, response):
        pass

    def predicates(self, args):
        return None

    def preemption_predicates(self, args):
        return []

    def send_event(self, events):
        pass

    def update_container_scheduling_state(self, request):
        pass

    def get_state_dump(self):
        return "{}"


def shard_front(dev, shards, nodes, cotenants=(), interval=0.05,
                failover=None, queues_yaml=""):
    """A scheduler of `shards` port cores on `dev` built as users build it
    (core/shard.make_core_scheduler; for shards >= 2 the sharded front),
    with `nodes` and the co-tenant pods registered, and `queues_yaml`'s
    queues (dynamic queues when it is empty). (core, cache, callback)."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.common import si
    from yunikorn_tpu_torch.core.shard import make_core_scheduler

    cache = SchedulerCache()
    cb = CountingCallback()
    core = make_core_scheduler(cache, shards=shards, interval=interval,
                               failover_options=failover, device=dev)
    core.register_resource_manager(si.RegisterResourceManagerRequest(
        rm_id="smoke", policy_group="queues", config=queues_yaml), cb)
    infos = []
    for n in nodes:
        cache.update_node(n)
        infos.append(si.NodeInfo(node_id=n.name, action=si.NodeAction.CREATE,
                                 node=n))
    core.update_node(si.NodeRequest(nodes=infos))
    for p in cotenants:
        cache.update_pod(p)
    return core, cache, cb


def submit_apps(core, app_ids, queue):
    from yunikorn_tpu_torch.common import si

    core.update_application(si.ApplicationRequest(new=[
        si.AddApplicationRequest(application_id=a, queue_name=queue,
                                 user=si.UserGroupInfo(user="smoke"))
        for a in app_ids]))


def shard_pass(dev, shards, fleet, wave=256, wave_gap_s=0.01, stall_s=3.0,
               timeout_s=120.0):
    """scripts/shard_bench.py's run_pass on the port: the wave streams in
    in bursts of `wave` asks while the shards' own cycle loops drain it;
    placed, packed cpu, pods/s from the start to the last placement, the
    admitted cycles, best_nodes' launches, and for the sharded front the
    ledger's audit and the usage mirror's divergence. Every best_nodes
    call the cores make (on whichever shard's thread) is captured and
    held against best_nodes_reference after the run: bit-equal, or the
    pass raises."""
    from yunikorn_tpu_torch.common.si import AllocationRequest
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes

    nodes, cotenants, asks = fleet
    core, _, cb = shard_front(dev, shards, nodes, cotenants, SHARD_INTERVAL)
    submit_apps(core, sorted({a for a, _ in asks}), "root.tenants")
    bursts = [asks[i:i + wave] for i in range(0, len(asks), wave)]
    with capturing_best_nodes() as captured:
        best_nodes.launches = 0
        t0 = time.perf_counter()
        core.start()
        try:
            for burst in bursts:
                core.update_allocation(AllocationRequest(
                    asks=[a for _, a in burst]))
                time.sleep(wave_gap_s)
            while True:
                with cb.mu:
                    placed, last = len(cb.placed), cb.last_place_at
                now = time.perf_counter()
                if (placed >= len(asks) or now - t0 > timeout_s
                        or (placed and now - last > stall_s)):
                    break
                time.sleep(0.02)
        finally:
            core.stop()
        launches = best_nodes.launches
    if len(captured) != launches:
        raise AssertionError(f"{shards} shards: {launches} launches but "
                             f"{len(captured)} calls captured")
    max_abs_err = hold_calls(captured, f"a {shards}-shard call's inputs")
    with cb.mu:
        allocs = list(cb.placed.values())
        wall = max(cb.last_place_at - t0, 1e-6)
    hist = core.obs.get("cycle_stage_ms")
    out = {"shards": shards, "placed": len(allocs),
           "packed_cpu": sum(a.resource.get("cpu") or 0 for a in allocs),
           "wall_s": wall, "pods_per_s": len(allocs) / wall,
           "best_nodes_launches": launches,
           "calls_held": len(captured), "max_abs_err": max_abs_err,
           "call_shapes_nm": sorted({(int(a[0].shape[0]), int(a[4].shape[0]))
                                     for a, _ in captured})}
    if shards > 1:
        out["cycles"] = sum(int(hist.child_state(stage="total",
                                                 shard=str(k))[0])
                            for k in range(shards))
        out["audit"] = core.ledger.audit()
        out["mirror_divergence"] = core.usage_mirror.divergence()
        out["mirror"] = core.usage_mirror.stats()
        out["bound_per_shard"] = [s["bound"]
                                  for s in core.shard_report()["shards"]]
    else:
        out["cycles"] = int(hist.child_state(stage="total")[0])
    return out


def shard_bench(dev, stats):
    """scripts/shard_bench.py's workload (client/synthetic.make_shard_fleet,
    seed SHARD_SEED) through 1 and SHARD_COUNT shards on the card. Bars
    (the bench's): placed and packed units at SHARD_COUNT shards >=
    SHARD_MIN_QUALITY x the 1-shard run's, the ledger's audit empty and
    the mirror's divergence 0. Reports pods/s and the speedup (no bar)."""
    from yunikorn_tpu_torch.client.synthetic import make_shard_fleet

    shape = SHARD_SHAPE
    fleet = make_shard_fleet(*shape, seed=SHARD_SEED)
    runs = [shard_pass(dev, n, fleet) for n in (1, SHARD_COUNT)]
    base, best = runs
    q_placed = best["placed"] / max(base["placed"], 1)
    q_packed = best["packed_cpu"] / max(base["packed_cpu"], 1)
    if (q_placed < SHARD_MIN_QUALITY or q_packed < SHARD_MIN_QUALITY
            or best["audit"] or best["mirror_divergence"]):
        raise AssertionError(f"{SHARD_COUNT} shards against 1: placed "
                             f"{q_placed:.4f}x, packed {q_packed:.4f}x, "
                             f"audit {best['audit']}, divergence "
                             f"{best['mirror_divergence']}")
    errs = [r["max_abs_err"] for r in runs if r["max_abs_err"] is not None]
    stats.setdefault("best_nodes", {}).update(
        launches_shard=best["best_nodes_launches"],
        held_shard_calls=sum(r["calls_held"] for r in runs),
        max_abs_err_shard=max(errs, default=None))
    return {"shape": shape, "runs": runs, "placed_ratio": q_placed,
            "packed_ratio": q_packed,
            "speedup": best["pods_per_s"] / base["pods_per_s"]}


def mirror_exact(front, timeout_s=10.0):
    """Poll the sharded front's usage mirror until, drained, it equals the
    ledger's confirmed usage cell for cell (divergence() 0 and host_usage()
    == usage_snapshot(); a shard's drain may be in flight between its
    journal swap and its fold). Raises at the timeout; returns the polls
    taken and the mirror's stats."""
    mirror, ledger = front.usage_mirror, front.ledger
    deadline = time.perf_counter() + timeout_s
    polls = 0
    while True:
        polls += 1
        div = mirror.divergence()
        if div == 0 and mirror.host_usage() == ledger.usage_snapshot():
            return {"polls": polls, **mirror.stats()}
        if time.perf_counter() > deadline:
            raise AssertionError(f"mirror diverged: {div} cells after "
                                 f"{polls} polls")
        time.sleep(0.05)


def shard_failover(dev):
    """scripts/failover_bench.py's cell on the port: n_pods bound across
    every shard, a second wave landing, then quarantine_shard(1) and the
    drain. The pods go to a queue with a max (FAILOVER_QUEUES), so every
    bind reserves and commits through the ledger and the shards' cycles
    drain its deltas into the usage mirror on the card, the dead shard's
    epoch fenced while the second wave binds. Bars: every node the dead
    shard owned re-homed, every ask bound and its pod in the ledger's
    confirmed usage, the dead shard's mirror epoch bumped and a late
    refresh with its old stamp fenced, and after each phase the ledger's
    audit empty and the mirror equal to the ledger's confirmed usage
    (mirror_exact). Reports the journal's undrained deltas at the
    quarantine and which shards' rows of the card's [S, T, K] tensor
    carry usage (the shards' cycles drain into their own rows)."""
    from yunikorn_tpu_torch.common.objects import make_node, make_pod
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk, AllocationRequest
    from yunikorn_tpu_torch.robustness.failover import FailoverOptions

    n_nodes, n_shards, n_pods = FAILOVER_NODES, FAILOVER_SHARDS, FAILOVER_PODS
    still = FailoverOptions(stale_budget_s=3600.0, probe_interval_s=3600.0,
                            rejoin_after_s=3600.0)
    t0 = time.perf_counter()
    front, _, cb = shard_front(
        dev, n_shards, [make_node(f"bn-{i}", cpu_milli=8000)
                        for i in range(n_nodes)], failover=still,
        queues_yaml=FAILOVER_QUEUES)
    registration_s = time.perf_counter() - t0
    apps = [f"bapp-{i}" for i in range(max(n_shards * 4, 16))]
    submit_apps(front, apps, "root.capped")

    def wave(prefix, count):
        keys = []
        for i in range(count):
            pod = make_pod(f"{prefix}-{i}", cpu_milli=200, memory=2**27)
            keys.append(f"{prefix}-{i}")
            front.update_allocation(AllocationRequest(asks=[AllocationAsk(
                allocation_key=keys[-1], application_id=apps[i % len(apps)],
                resource=get_pod_resource(pod), pod=pod)]))
        return keys

    def wait_bound(keys, timeout):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with cb.mu:
                if all(k in cb.placed for k in keys):
                    return True
            time.sleep(0.05)
        return False

    front.start()
    try:
        keys = wave("bp", n_pods)
        if not wait_bound(keys, 120):
            raise AssertionError("the working set did not bind")
        audit_bound = front.ledger.audit()
        mirror_bound = mirror_exact(front)
        victim = 1 % n_shards
        owned_before = front.fanout.count_for(victim)
        keys += wave("bw", max(n_pods // 4, n_shards * 8))
        parked = sum(1 for k, h in front._ask_home.items()
                     if h == victim and k not in front._alloc_shard)
        in_flight = len(front.ledger._deltas or ())
        t_q = time.perf_counter()
        ok = front.quarantine_shard(victim, "smoke")
        quarantine_s = time.perf_counter() - t_q
        audit_q = front.ledger.audit()
        # the dead shard's cycle refreshing late with its stale stamp
        stale = mirror_bound["epochs"][victim]
        fenced = front.usage_mirror.fenced_refreshes
        front.usage_mirror.refresh(victim, front.ledger, epoch=stale)
        fenced = front.usage_mirror.fenced_refreshes - fenced
        mirror_q = mirror_exact(front)
        t_r = time.perf_counter()
        all_bound = wait_bound(keys, 120)
        recover_s = time.perf_counter() - t_r
        mirror_final = mirror_exact(front)
        out = {"shards": n_shards, "nodes": n_nodes, "pods": n_pods,
               "registration_s": registration_s,
               "owned_before": owned_before, "parked_before": parked,
               "quarantine_ok": bool(ok), "quarantine_s": quarantine_s,
               "rehomed_nodes": front._rehomed_nodes_total,
               "owned_after": front.fanout.count_for(victim),
               "recover_s": recover_s, "bound": len(cb.placed),
               "asks": len(keys), "audit_after_bind": audit_bound,
               "audit_after_quarantine": audit_q,
               "audit_final": front.ledger.audit(),
               "mirror_after_bind": mirror_bound,
               "mirror_after_quarantine": mirror_q,
               "mirror_final": mirror_final,
               "journal_at_quarantine": in_flight,
               "stale_refreshes_fenced": fenced,
               "mirror_device": str(front.usage_mirror.device),
               "shard_rows_charged": (front.usage_mirror._dev != 0)
               .flatten(1).any(1).tolist(),
               "confirmed_usage": front.ledger.usage_snapshot()}
    finally:
        front.stop()
    if not (ok and all_bound and out["rehomed_nodes"] == owned_before
            and out["owned_after"] == 0 and not audit_bound
            and not audit_q and not out["audit_final"]
            and out["confirmed_usage"].get("q|root.capped", {}).get("pods")
            == len(keys)
            and mirror_final["epochs"][victim] > stale and fenced == 1):
        raise AssertionError(f"failover cell: {out}")
    return out


def shard_cmd():
    """The binary with the sharded front: `--nodes SHARD_CMD_NODES --pods
    SHARD_CMD_PODS --shards 2 --ledger-serve` in a subprocess on the card:
    /ws/v1/shards reports every node and every pod bound, /metrics the
    shard series, SIGTERM exits 0."""
    import signal
    import tempfile

    port = free_port()
    log_path = os.path.join(tempfile.mkdtemp(prefix="yk-shard-cmd-"),
                            "scheduler.log")
    argv = scheduler_argv("--nodes", str(SHARD_CMD_NODES), "--pods",
                          str(SHARD_CMD_PODS), "--rest-port", str(port),
                          "--shards", "2", "--ledger-serve")
    out = {"argv": argv[2:]}

    def counts():
        status, body = rest_call(port, "/ws/v1/shards")
        if status != 200:
            return 0, 0
        shards = json.loads(body)["shards"]
        return (sum(s["nodes"] for s in shards),
                sum(s["bound"] for s in shards))

    def wait(cond, what, timeout):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f"the scheduler exited "
                                     f"{proc.returncode} waiting for {what}")
            try:
                if cond():
                    return time.perf_counter()
            except OSError:
                pass
            time.sleep(0.1)
        raise AssertionError(f"timed out waiting for {what}")

    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.DEVNULL,
                                stderr=log)
        try:
            out["nodes_ready_s"] = wait(
                lambda: counts()[0] == SHARD_CMD_NODES,
                f"{SHARD_CMD_NODES} nodes", 120) - t0
            out["all_bound_s"] = wait(
                lambda: counts()[1] == SHARD_CMD_PODS,
                f"{SHARD_CMD_PODS} pods bound", 120) - t0
            status, metrics = rest_call(port, "/metrics")
            if status != 200 or "yunikorn_shard_count 2" not in metrics:
                raise AssertionError("/metrics lacks yunikorn_shard_count 2")
            status, shards = rest_call(port, "/ws/v1/shards")
            rep = json.loads(shards)
            out["bound_per_shard"] = [s["bound"] for s in rep["shards"]]
            out["ledger"] = rep.get("ledger")
            proc.send_signal(signal.SIGTERM)
            t_term = time.perf_counter()
            out["exit_code"] = proc.wait(timeout=30)
            out["exit_s"] = time.perf_counter() - t_term
        except Exception as e:
            tail = open(log_path).read()[-1500:]
            raise AssertionError(f"{type(e).__name__}: {e}; the scheduler's "
                                 f"log ends: {tail}") from e
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    if out["exit_code"] != 0:
        raise AssertionError(f"exit code {out['exit_code']}")
    log_text = open(log_path).read()
    for line in ("control-plane sharding: 2 shards", "ledger service",
                 "device=cuda"):
        if line not in log_text:
            raise AssertionError(f"the scheduler's log lacks {line!r}")
    return out


def shard_mirror(dev):
    """The usage mirror on the card: usage_apply / usage_fold against the
    CPU on int64 deltas up to 2^62 with repeated cells (bit-equal), and a
    DeviceUsageMirror on the card through MIRROR_OPS random ledger
    operations over MIRROR_TRACKERS trackers and 8 resources, drained
    every 64 operations and by every stale-epoch refresh of a fenced
    shard: divergence 0 after every drain; the ms of a drain of 64
    operations (host clock around refresh, which reads the fold back)."""
    import random

    from yunikorn_tpu_torch.core.shard import GlobalQuotaLedger
    from yunikorn_tpu_torch.ops.gate_solve import usage_apply, usage_fold
    from yunikorn_tpu_torch.ops.ledger_mirror import DeviceUsageMirror

    rng = np.random.default_rng(0)
    S, T, K, B = 4, 64, 8, 4_096
    base = rng.integers(-2**61, 2**61, (S, T, K), dtype=np.int64)
    t_idx = rng.integers(0, 4, B)
    k_idx = rng.integers(0, 2, B)
    vals = rng.integers(-2**62 // B, 2**62 // B, B, dtype=np.int64)
    outs = []
    for d in (dev, torch.device("cpu")):
        x = torch.from_numpy(base.copy()).to(d)
        usage_apply(x, 2, *(torch.from_numpy(a).to(d)
                            for a in (t_idx, k_idx, vals)))
        outs.append((x.cpu(), usage_fold(x).cpu()))
    if not (torch.equal(outs[0][0], outs[1][0])
            and torch.equal(outs[0][1], outs[1][1])):
        raise AssertionError("usage_apply / usage_fold: card != cpu")
    ledger = GlobalQuotaLedger()
    mirror = DeviceUsageMirror(SHARD_COUNT, device=dev)
    ledger.attach_mirror(mirror)
    pyrng = random.Random(0)
    live, drains, refresh_ms = [], 0, []
    for i in range(MIRROR_OPS):
        if live and pyrng.random() < 0.4:
            ledger.release(live.pop(pyrng.randrange(len(live))))
        else:
            tid = f"q|root.t{pyrng.randrange(MIRROR_TRACKERS)}"
            ch = [(tid, [(f"r{k}", 10**15) for k in range(8)],
                   [(f"r{k}", pyrng.randrange(1, 10**9)) for k in range(8)])]
            if ledger.reserve(f"k{i}", ch):
                ledger.commit(f"k{i}", ch)
                live.append(f"k{i}")
        if i % 64 == 63:
            shard = (i // 64) % SHARD_COUNT
            if pyrng.random() < 0.1:
                stale = mirror.epoch_of(shard)
                mirror.fence_shard(shard)
                mirror.refresh(shard, ledger, epoch=stale)
            t0 = time.perf_counter()
            mirror.refresh(shard, ledger, epoch=mirror.epoch_of(shard))
            refresh_ms.append((time.perf_counter() - t0) * 1e3)
            drains += 1
            if mirror.divergence(ledger):
                raise AssertionError(f"divergence after drain {drains}")
    if mirror.host_usage() != ledger.usage_snapshot():
        raise AssertionError("host usage != the ledger's snapshot")
    return {"apply_fold_bit_equal": True, "ops": MIRROR_OPS,
            "drains": drains, "divergence": 0, "stats": mirror.stats(),
            "refresh_ms_median": statistics.median(refresh_ms),
            "device": str(mirror._dev.device)}


def phase_shard(dev, stats):
    """The sharded control plane on the card: the usage mirror,
    shard_bench's workload at 1 and SHARD_COUNT shards, failover_bench's
    quarantine cell, and the binary with --shards 2 --ledger-serve."""
    return {"mirror": shard_mirror(dev), "bench": shard_bench(dev, stats),
            "failover": shard_failover(dev), "cmd": shard_cmd()}


def hold_shard_calls(captured, where):
    """Each captured best_nodes call of a sharded solve (node_offset /
    m_total / keys_out) again through the kernel and through
    best_nodes_reference, each with keys of its own: raises unless best,
    feasible and the keys are bit-equal. Returns (the largest |best -
    best_ref|, the shard offsets held)."""
    from yunikorn_tpu_torch.ops.best_nodes import (best_nodes,
                                                   best_nodes_reference)

    err, offsets = 0, set()
    for args, kwargs in captured:
        outs = []
        for fn in (best_nodes, best_nodes_reference):
            keys = torch.empty_like(kwargs["keys_out"])
            outs.append(fn(*args, **dict(kwargs, keys_out=keys)) + (keys,))
        (b, f, k), (b_ref, f_ref, k_ref) = outs
        err = max(err, int((b.long() - b_ref.long()).abs().max()))
        if not (torch.equal(b, b_ref) and torch.equal(f, f_ref)
                and torch.equal(k, k_ref)):
            raise AssertionError(f"kernel differs from plain at {where}, "
                                 f"shard offset {kwargs['node_offset']}")
        offsets.add(kwargs["node_offset"])
    return err, sorted(offsets)


def mesh_kernel(args, kwargs, mesh, clock_hz):
    """best_nodes at one call's inputs cut into the mesh's node shards
    (node_offset / m_total / keys_out): each shard's keys and best equal
    the plain version's, the merged keys equal the unsharded kernel call;
    each shard call's CUDA-event ms beside its bound."""
    from yunikorn_tpu_torch.ops.best_nodes import (best_nodes,
                                                   best_nodes_reference,
                                                   merge_keys)

    req, gid, feas, soft, free, base = args
    M = free.shape[0]
    # a captured call of the mesh of one carries its own shard arguments
    kwargs = {k: v for k, v in kwargs.items()
              if k not in ("node_offset", "m_total", "keys_out")}
    want = best_nodes(*args, **kwargs)
    keys, shards = [], []
    for lo, hi in mesh.bounds(M):
        part = (req, gid, feas[:, lo:hi].contiguous(),
                soft[:, lo:hi].contiguous(), free[lo:hi], base[lo:hi])
        kw = dict(kwargs, node_offset=lo, m_total=M)
        k, k_ref = (torch.empty((req.shape[0],), dtype=torch.int64,
                                device=req.device) for _ in range(2))
        got = best_nodes(*part, keys_out=k, **kw)
        ref = best_nodes_reference(*part, keys_out=k_ref, **kw)
        if not (torch.equal(k, k_ref) and torch.equal(got[0], ref[0])
                and torch.equal(got[1], ref[1])):
            raise AssertionError(f"shard at {lo}: kernel != plain")
        keys.append(k)
        b = best_nodes_bound_ms(req, gid, part[2], part[4],
                                kw.get("has_soft", True), clock_hz,
                                rows=kw.get("rows"))
        shards.append({
            "offset": lo, "nodes": hi - lo, "rows": b["rows"],
            "ms": cuda_ms(lambda: best_nodes(*part, keys_out=k, **kw), 10),
            "plain_ms": cuda_ms(
                lambda: best_nodes_reference(*part, keys_out=k_ref, **kw), 3),
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]})
    merged = merge_keys(keys, M)
    if not (torch.equal(merged[0], want[0])
            and torch.equal(merged[1], want[1])):
        raise AssertionError("the merged shard keys differ from the "
                             "unsharded kernel call")
    return {"shape": [req.shape[0], M], "shards": shards,
            "merged_equal_unsharded": True}


def same_result(a, b, fields=("assigned", "accept_round", "free_after")):
    """The fields (and rounds) of two SolveResults equal, bit for bit."""
    same = {f: bool(torch.equal(getattr(a, f), getattr(b, f)))
            for f in fields}
    same["rounds"] = a.rounds == b.rounds
    return same


def mesh_solve(dev, mesh, stats, clock_hz):
    """The pressure solve (MAIN_NODES x MAIN_PODS) over the mesh against
    the single-device solve on the card: assigned, accept_round,
    free_after and rounds equal, the JAX
    package's 16 rounds / 45,977 placed, best_nodes launched once a shard
    in each odd round (counted from 0 around the sharded run) and every
    call held against the plain version; the shard kernel at the first odd
    round's inputs; the warm medians of both; then the chained form at
    max_batch MESH_CHUNK_BATCH."""
    from yunikorn_tpu_torch.ops.assign import solve_batch
    from yunikorn_tpu_torch.ops.best_nodes import best_nodes
    from yunikorn_tpu_torch.parallel.mesh import solve_sharded

    enc, batch, pods, _ = build_workload(MAIN_NODES, MAIN_PODS)
    n = len(pods)
    single, captured_single, _, _ = solve_capturing(batch, enc, dev)
    with capturing_best_nodes() as captured:
        best_nodes.launches = 0
        torch.cuda.synchronize()
        sharded = solve_sharded(batch, enc.nodes, mesh, **SOLVE_KW)
        torch.cuda.synchronize()
        launches = best_nodes.launches
    same = same_result(single, sharded)
    if not all(same.values()):
        raise AssertionError(f"sharded and single-device solves differ: "
                             f"{same}")
    placed = int((sharded.assigned[:n] >= 0).sum())
    if (sharded.rounds, placed) != EXPECTED[(MAIN_NODES, MAIN_PODS)]:
        raise AssertionError(f"rounds/placed {(sharded.rounds, placed)}")
    want_launches = mesh.size * (sharded.rounds // 2)
    if launches != want_launches:
        raise AssertionError(f"{launches} best_nodes launches, expected "
                             f"{want_launches}")
    err, offsets = hold_shard_calls(captured, "the sharded pressure solve")
    if len(offsets) != mesh.size:
        raise AssertionError(f"calls held at shard offsets {offsets}")
    kernel = mesh_kernel(*captured_single[0], mesh, clock_hz)
    stats.setdefault("best_nodes", {}).update(
        launches_mesh=launches, held_mesh_calls=len(captured),
        max_abs_err_mesh=err,
        mesh_shard_ms=[s["ms"] for s in kernel["shards"]],
        mesh_shard_bound_ms=[s["bound_ms"] for s in kernel["shards"]])
    warm_single = warm_median_ms(lambda: solve_batch(
        batch, enc.nodes, device=dev, **SOLVE_KW), runs=3)[0]
    warm_mesh = warm_median_ms(lambda: solve_sharded(
        batch, enc.nodes, mesh, **SOLVE_KW), runs=3)[0]
    chunk_kw = dict(SOLVE_KW, max_batch=MESH_CHUNK_BATCH)
    chained = same_result(
        solve_batch(batch, enc.nodes, device=dev, **chunk_kw),
        solve_sharded(batch, enc.nodes, mesh, **chunk_kw))
    if not all(chained.values()):
        raise AssertionError(f"chained solves differ: {chained}")
    return {"nodes": MAIN_NODES, "pods": MAIN_PODS, "identical": same,
            "rounds": sharded.rounds, "placed": placed,
            "best_nodes_launches": launches, "held_calls": len(captured),
            "held_offsets": offsets, "max_abs_err": err, "kernel": kernel,
            "warm_ms": {"single": warm_single, "mesh": warm_mesh},
            "chained": {"max_batch": MESH_CHUNK_BATCH, "identical": chained}}


def mesh_locality_topology(dev, mesh):
    """The locality mix at the cut and the steered gang wave (TOPO_*) over
    the mesh against the single-device solve on the card: every output
    equal, the JAX package's counts."""
    from yunikorn_tpu_torch.client.synthetic import make_locality_pods
    from yunikorn_tpu_torch.ops.assign import solve_batch
    from yunikorn_tpu_torch.parallel.mesh import solve_sharded

    enc, batch, pods, _ = build_workload(CUT_NODES, CUT_PODS,
                                         make_locality_pods)
    single = solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
    sharded = solve_sharded(batch, enc.nodes, mesh, **SOLVE_KW)
    loc = same_result(single, sharded, ("assigned", "accept_round",
                                        "free_after", "cnt_final"))
    placed = int((sharded.assigned[:len(pods)] >= 0).sum())
    if (not all(loc.values()) or (sharded.rounds, placed)
            != EXPECTED_LOCALITY[(CUT_NODES, CUT_PODS)]):
        raise AssertionError(f"locality: {loc}, {(sharded.rounds, placed)}")
    shape = (TOPO_PODS, TOPO_NODES, TOPO_DOMAINS)
    enc, batch, asks, gangs, _, _ = topology_workload(*shape)
    fold_topology(batch, asks, enc)
    single = solve_batch(batch, enc.nodes, device=dev, **SOLVE_KW)
    sharded = solve_sharded(batch, enc.nodes, mesh, **SOLVE_KW)
    topo = same_result(single, sharded)
    got = topology_result(batch, asks, gangs, enc, sharded)
    if not all(topo.values()):
        raise AssertionError(f"steered solves differ: {topo}")
    check_expected_topology(shape, got)
    return {"locality": {"nodes": CUT_NODES, "pods": CUT_PODS,
                         "identical": loc, "rounds": sharded.rounds,
                         "placed": placed},
            "topology": {"shape": shape, "identical": topo, **got}}


def mesh_preempt_fold_pack(dev, mesh):
    """Preemption (PREEMPT_ASKS asks on PREEMPT_NODES nodes of victims),
    the usage mirror's fold and the pack arm over the mesh against the
    single device on the card."""
    import random

    from yunikorn_tpu_torch.core.preemption import plan_preemptions_batched
    from yunikorn_tpu_torch.core.shard import GlobalQuotaLedger
    from yunikorn_tpu_torch.ops import assign, pack_solve
    from yunikorn_tpu_torch.ops.ledger_mirror import DeviceUsageMirror
    from yunikorn_tpu_torch.parallel.mesh import pack_solve_sharded

    cache, enc, asks, app_of_pod = preempt_cluster(0, PREEMPT_NODES,
                                                   PREEMPT_ASKS)
    cands = list(cache.node_names())
    single, _, s1 = plan_preemptions_batched(cache, enc, asks, app_of_pod,
                                             candidate_nodes=cands,
                                             device=dev)
    sharded, _, s4 = plan_preemptions_batched(cache, enc, asks, app_of_pod,
                                              candidate_nodes=cands,
                                              mesh=mesh)
    if (plans_key(single) != plans_key(sharded) or not s4["sharded"]
            or len(sharded) != EXPECTED_PREEMPT[0]):
        raise AssertionError(f"sharded plans differ ({len(sharded)} plans, "
                             f"stats {s4})")
    # the fold: the same ledger operations into a mirror on the card and
    # one over the mesh
    ledger = GlobalQuotaLedger()
    ledger.enable_journal()
    mirrors = [DeviceUsageMirror(SHARD_COUNT, device=dev),
               DeviceUsageMirror(SHARD_COUNT, mesh=mesh)]
    pyrng = random.Random(1)
    for i in range(512):
        tid = f"q|root.t{pyrng.randrange(16)}"
        ch = [(tid, [(f"r{k}", 10**15) for k in range(4)],
               [(f"r{k}", pyrng.randrange(1, 10**9)) for k in range(4)])]
        if ledger.reserve(f"k{i}", ch):
            ledger.commit(f"k{i}", ch)
        if i % 64 == 63:
            deltas = ledger.drain_deltas()
            for m in mirrors:
                ledger.requeue_deltas(deltas)
                m.refresh(i // 64, ledger)
    fold = {"sharded_fold": mirrors[1].stats()["sharded_fold"],
            "divergence": mirrors[1].divergence(ledger),
            "fleet_equal": bool(np.array_equal(mirrors[0]._fleet,
                                               mirrors[1]._fleet))}
    if fold != {"sharded_fold": True, "divergence": 0, "fleet_equal": True}:
        raise AssertionError(f"sharded fold: {fold}")
    n_pods, n_nodes = PACK_SHAPES[-1]
    enc, batch, _ = duel_fleet(n_pods, n_nodes)
    got = pack_solve_sharded(batch, enc.nodes, mesh, seed=DUEL_SEED)
    np_args, static = assign.prepare_solve_args(batch, enc.nodes)
    args, _ = assign.solve_args_from_numpy(np_args, static, dev)
    want = pack_solve.pack_solve(
        *args, DUEL_SEED, n_parts=got.n_parts, partitioner="topo",
        n_shards=mesh.size, score_cols=static["score_cols"], device=dev)
    if not (torch.equal(got.assigned, want[0])
            and torch.equal(got.free_after, want[1]) and bool(got.feasible)):
        raise AssertionError("sharded pack differs from the single-device "
                             "pack with the same shards")
    return {"preempt": {"nodes": PREEMPT_NODES, "asks": PREEMPT_ASKS,
                        "plans": len(sharded), "equal": True,
                        "mirror_upload_bytes": s4.get("mirror_upload_bytes")},
            "fold": fold,
            "pack": {"pods": n_pods, "nodes": n_nodes, "parts": got.n_parts,
                     "placed": int((got.assigned[:batch.num_pods] >= 0)
                                   .sum()), "equal": True}}


def mesh_cores(dev, mesh):
    """CoreScheduler(SolverOptions(shard=True)) against shard=False on the
    card, pod for pod: bench.py's core shape (the mesh core's cold cycle, a
    release and a warm one: the mirror clean, 0 node bytes) and the
    pressure cut. The mesh circuit closed with 0 failures."""
    from yunikorn_tpu_torch.client.synthetic import (PRESSURE_APPS,
                                                     make_kwok_nodes,
                                                     make_pressure_nodes,
                                                     make_pressure_pods,
                                                     make_sleep_pods)
    from yunikorn_tpu_torch.core.scheduler import SolverOptions

    queues = [(f"bench-app-{q}", f"root.q{q}") for q in range(5)]
    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(PRESSURE_APPS))]
    out = {}
    for label, nodes_of, pods_of, apps_of in (
            ("core_shape", lambda: make_kwok_nodes(MAIN_NODES),
             lambda: [p for app, q in queues for p in make_sleep_pods(
                 MAIN_PODS // 5, app, queue=q, name_prefix=q.split(".")[-1])],
             queues),
            ("pressure_cut", lambda: make_pressure_nodes(CUT_NODES),
             lambda: make_pressure_pods(CUT_PODS), apps)):
        binds, runs = {}, {}
        # the mesh core first: its warm cycle runs before the other core's
        # objects exist
        for shard in (True, False):
            _, core, cb = make_core(dev, nodes_of(), apps_of,
                                    solver=SolverOptions(shard=shard))
            pods = pods_of()
            names = {p.uid: p.metadata.name for p in pods}
            asks = asks_of(pods)
            n, cold_s = core_cycle(core, asks)
            cold = cycle_split(core)
            run = {"placed": n, "cycle_ms": cold_s * 1e3, "split": cold,
                   "node_upload_bytes": cold.get("node_upload_bytes"),
                   "replicated_bytes": core.metrics["last_cycle"]["default"]
                   .get("replicated_bytes")}
            binds[shard] = {names[k]: v for k, v in cb.bound.items()}
            if shard and label == "core_shape":
                release_all(core, asks)
                n_warm, warm_s = core_cycle(core, asks)
                warm = core.metrics["last_cycle"]["default"]
                run.update(warm_placed=n_warm, warm_cycle_ms=warm_s * 1e3,
                           warm_split=cycle_split(core),
                           warm_node_refresh=warm.get("node_refresh"),
                           warm_node_upload_bytes=warm.get(
                               "node_upload_bytes"),
                           warm_replicated_bytes=warm.get(
                               "replicated_bytes"))
                if (warm.get("node_refresh"),
                        warm.get("node_upload_bytes")) != ("clean", 0):
                    raise AssertionError(f"a clean warm mesh cycle uploaded "
                                         f"{warm.get('node_upload_bytes')}")
            check_tiers(core, f"{label} shard={shard}")
            if shard:
                if core._mesh is None or core._mesh.size != mesh.size:
                    raise AssertionError(f"the core's mesh is {core._mesh}")
                circuit = core.supervisor.snapshot()["mesh"]["circuits"]
                fallbacks = core.metrics.get("solve_mesh_fallbacks_total")
                if (circuit != {"device": {"state": "closed", "failures": 0}}
                        or fallbacks or not run["replicated_bytes"]):
                    raise AssertionError(f"{label}: mesh circuit {circuit}, "
                                         f"fallbacks {fallbacks}, {run}")
                run["mesh_failures"] = 0
            runs["mesh" if shard else "single"] = run
        if binds[True] != binds[False]:
            diff = sum(binds[True].get(k) != v for k, v in binds[False].items())
            raise AssertionError(f"{label}: the mesh core binds {diff} pods "
                                 "differently")
        out[label] = {"identical": True, "bound": len(binds[True]), **runs}
    return out


def finish_bound_ms(inp) -> dict:
    """Least time for one learned_propose finish: its inputs read once (the
    node embedding's row at each pick) and its outputs written once over
    HBM bandwidth; its operations (the slice adds in float64, one dot
    product a row) are a few a byte, so the bytes bound it."""
    N, S = inp["partial"].shape
    E = inp["pod_emb"].shape[1]
    nbytes = N * (1 + 8 + 4 + 8 * S + 2 * 4 * E) + N * 16
    return {"bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes"}


def mesh_learned(dev, mesh, stats, clock_hz):
    """The learned solve at full width (the pressure solve's MAIN_NODES x
    MAIN_PODS, the committed checkpoint, seed LEARNED_SEED) over the mesh
    against the single device on the card: assigned, accept_round,
    free_after and rounds equal; learned_propose launched once a shard a
    round, its finish once a round and best_nodes once a shard in each odd
    round (counted from 0 around the sharded run); every shard call and
    finish held against the plain version (keys, nf and slice sums; the
    finish bit for bit, lmean error 0) and every odd round's best_nodes
    shard call, with its learned term, held with its keys; round 0's shard
    calls and finish and the first odd round's best_nodes shard calls timed
    beside their bounds and plain versions; the warm medians of 3 of both
    solves. Then policy_bench's eval shape
    (LEARNED_EVAL) sharded: equal to the single device, EXPECTED_LEARNED's
    winner and units."""
    from yunikorn_tpu_torch.ops import learned as lmod
    from yunikorn_tpu_torch.ops import pack_solve
    from yunikorn_tpu_torch.ops.assign import solve_batch
    from yunikorn_tpu_torch.ops.best_nodes import (best_nodes,
                                                   best_nodes_reference)
    from yunikorn_tpu_torch.parallel.mesh import solve_sharded
    from yunikorn_tpu_torch.policy import net

    params = net.params_from_numpy(net.load_checkpoint(LEARNED_CKPT).params,
                                   dev)
    learned = (params, LEARNED_SEED)
    enc, batch, _pods, _ = build_workload(MAIN_NODES, MAIN_PODS)
    single = solve_batch(batch, enc.nodes, device=dev, learned=learned,
                         **SOLVE_KW)
    with capturing_best_nodes() as bn_calls, \
            capturing_learned_propose() as lp_calls:
        torch.cuda.synchronize()
        best_nodes.launches = 0
        lmod.learned_propose.launches = 0
        lmod.learned_propose_finish.launches = 0
        sharded = solve_sharded(batch, enc.nodes, mesh, learned=learned,
                                **SOLVE_KW)
        torch.cuda.synchronize()
        launches = {"learned_propose": lmod.learned_propose.launches,
                    "learned_propose_finish":
                        lmod.learned_propose_finish.launches,
                    "best_nodes": best_nodes.launches}
    same = same_result(single, sharded)
    if not all(same.values()):
        raise AssertionError(f"sharded and single-device learned solves "
                             f"differ: {same}")
    r = sharded.rounds
    want = {"learned_propose": mesh.size * r, "learned_propose_finish": r,
            "best_nodes": mesh.size * (r // 2)}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    held = hold_learned_calls(lp_calls, "the sharded learned solve")
    if not all("pod_emb" in kw for _args, kw in bn_calls):
        raise AssertionError("an odd round's shard call lacks the learned "
                             "term")
    err, offsets = hold_shard_calls(bn_calls, "the sharded learned solve")
    if len(offsets) != mesh.size:
        raise AssertionError(f"calls held at shard offsets {offsets}")
    # round 0's shard calls and the first odd round's best_nodes shard
    # calls, timed beside their bounds; each plain version on the first
    # shard only (it is as slow on each)
    shards = []
    for i, inp in enumerate(lp_calls["shard"][:mesh.size]):
        b = learned_propose_bound_ms(inp, clock_hz)
        shards.append({
            "offset": inp["node_offset"], "rows": b["rows"],
            "fitting_pairs": b["fitting_pairs"],
            "ms": cuda_ms(lambda inp=inp: lmod.learned_propose_shard(**inp),
                          5),
            "plain_ms": None if i else cuda_ms(
                lambda: lmod.learned_propose_shard_reference(**inp), 1),
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]})
    bn_shards = []
    for i, (args, kw) in enumerate(bn_calls[:mesh.size]):
        b = best_nodes_bound_ms(args[0], args[1], args[2], args[4], True,
                                clock_hz, rows=kw["rows"],
                                emb=kw["pod_emb"].shape[1])
        bn_shards.append({
            "offset": kw["node_offset"], "rows": b["rows"],
            "ms": cuda_ms(lambda a=args, k=kw: best_nodes(*a, **k), 10),
            "plain_ms": None if i else cuda_ms(
                lambda: best_nodes_reference(*args, **kw), 1),
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]})
    fin = lp_calls["finish"][0]
    fin_ref = lmod.learned_propose_finish_reference
    finish = dict(finish_bound_ms(fin),
                  ms=cuda_ms(lambda: lmod.learned_propose_finish(**fin), 10),
                  plain_ms=cuda_ms(lambda: fin_ref(**fin), 3))
    stats.setdefault("learned_propose", {}).update(
        launches_mesh=launches["learned_propose"],
        launches_mesh_finish=launches["learned_propose_finish"],
        held_mesh_calls=held["calls"] + held["finish_calls"],
        max_abs_err_mesh=held["lmean_max_abs_err"],
        mesh_shard_ms=[c["ms"] for c in shards],
        mesh_shard_bound_ms=[c["bound_ms"] for c in shards],
        mesh_finish_ms=finish["ms"], mesh_finish_bound_ms=finish["bound_ms"])
    stats.setdefault("best_nodes", {}).update(
        launches_mesh_learned=launches["best_nodes"],
        held_mesh_learned_calls=len(bn_calls),
        max_abs_err_mesh_learned=err,
        mesh_learned_shard_ms=[c["ms"] for c in bn_shards],
        mesh_learned_shard_bound_ms=[c["bound_ms"] for c in bn_shards])
    warm = {"single": warm_median_ms(lambda: solve_batch(
                batch, enc.nodes, device=dev, learned=learned, **SOLVE_KW),
                runs=3)[0],
            "mesh": warm_median_ms(lambda: solve_sharded(
                batch, enc.nodes, mesh, learned=learned, **SOLVE_KW),
                runs=3)[0]}
    # policy_bench's eval shape, where the checkpoint's plan wins
    enc_e, batch_e, prio = learned_fleet(*LEARNED_EVAL)
    n = batch_e.num_pods
    ev_single = solve_batch(batch_e, enc_e.nodes, device=dev, learned=learned,
                            **SOLVE_KW)
    ev = solve_sharded(batch_e, enc_e.nodes, mesh, learned=learned,
                       **SOLVE_KW)
    ev_same = same_result(ev_single, ev)
    greedy = solve_sharded(batch_e, enc_e.nodes, mesh, **SOLVE_KW)
    winner, st = pack_solve.choose_plan_n(
        [("greedy", greedy.assigned[:n].cpu().numpy()),
         ("learned", ev.assigned[:n].cpu().numpy())],
        batch_e.req.astype(np.int32), batch_e.valid,
        cap_i=np.floor(enc_e.nodes.capacity_arr).astype(np.int64),
        priorities=np.asarray(prio))
    got = {k: (st[k]["placed"], st[k]["units_norm"]) for k in st}
    want_winner, want_units = EXPECTED_LEARNED
    if (not all(ev_same.values()) or winner != want_winner
            or abs(got["learned"][1] - want_units["learned"][1])
            > LEARNED_UNITS_RTOL * want_units["learned"][1]):
        raise AssertionError(f"eval shape: {ev_same}, {winner}, {got}")
    return {"nodes": MAIN_NODES, "pods": MAIN_PODS, "identical": same,
            "rounds": r, "placed": int((sharded.assigned >= 0).sum()),
            "launches": launches, "held": held,
            "held_best_nodes_calls": len(bn_calls),
            "held_best_nodes_offsets": offsets, "max_abs_err": err,
            "round0": {"shards": shards, "finish": finish},
            "first_odd_round_best_nodes": bn_shards,
            "warm_ms": warm,
            "eval": {"shape": list(LEARNED_EVAL), "identical": ev_same,
                     "winner": winner, "placed_units": got}}


def mesh_orders(dev, mesh):
    """The layout independence the mesh's bit-equality rests on, tested on
    the card's own ops over mesh.size shards against one piece: at each of
    MESH_ORDER_SHAPES the cvx arm's row sums (ops/cvx_solve.row_total), its
    price products (_price) and its loads (_load) in node_blocks' blocks;
    at each of MESH_TOWER_WIDTHS the node tower in EMB_BLOCK row blocks
    (ops/learned.embed_nodes). Raises unless each is bit-equal. Also
    reports whether the plain tower over the shards' row pieces equals one
    product over all rows (`pieces_equal`: where not, the card's product
    rounds by its row count, which is why embed_nodes runs in blocks)."""
    from yunikorn_tpu_torch.ops import cvx_solve as cvx
    from yunikorn_tpu_torch.ops.learned import embed_nodes
    from yunikorn_tpu_torch.parallel.mesh import NodeMesh
    from yunikorn_tpu_torch.policy import features as pf
    from yunikorn_tpu_torch.policy import net

    k, one = mesh.size, NodeMesh((dev,))
    rng = np.random.default_rng(LEARNED_SEED)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    out = {"cvx": [], "tower": []}
    for N, M in MESH_ORDER_SHAPES:
        X = t(rng.random((N, M)) * (rng.random((N, M)) < 0.3))
        req = t(rng.random((N, 8)))
        lam = t(rng.random((M, 8)) * (rng.random((M, 8)) < 0.5))
        chunk, block = cvx.node_blocks(M, [M])
        if cvx.node_blocks(M, [M // k] * k) != (chunk, block):
            raise AssertionError(f"node_blocks differ over {k} shards at {M}")
        Xp, lam_p = mesh.split(X, 1), mesh.split(lam)
        row = {"N": N, "M": M, "chunk": chunk, "block": block,
               "row_total": torch.equal(cvx.row_total(mesh, Xp, block),
                                        cvx.row_total(one, [X], block)),
               "price": torch.equal(
                   mesh.gather([cvx._price(mesh.put(req, i), lam_p[i], chunk)
                                for i in range(k)], 1),
                   cvx._price(req, lam, chunk)),
               "load": torch.equal(
                   mesh.gather([cvx._load(Xp[i], mesh.put(req, i))
                                for i in range(k)]), cvx._load(X, req))}
        out["cvx"].append(row)
        if not all(row[c] for c in ("row_total", "price", "load")):
            raise AssertionError(f"cvx blocks differ over {k} shards: {row}")
    params = net.params_from_numpy(net.load_checkpoint(LEARNED_CKPT).params,
                                   dev)
    for M in MESH_TOWER_WIDTHS:
        feats, W = t(rng.random((M, pf.F_NODE))), M // k
        pieces = [feats[i * W:(i + 1) * W].contiguous() for i in range(k)]
        row = {"M": M, "pieces_equal": torch.equal(
                   torch.cat([net.node_tower(params, p) for p in pieces]),
                   net.node_tower(params, feats)),
               "blocks_equal": torch.equal(
                   torch.cat([embed_nodes(params, p, i * W, M)
                              for i, p in enumerate(pieces)]),
                   embed_nodes(params, feats))}
        out["tower"].append(row)
        if not row["blocks_equal"]:
            raise AssertionError(f"node tower differs over {k} shards: {row}")
    return out


def mesh_cvx(dev, mesh):
    """cvx_solve_sharded against cvx_solve_batch on the card at the
    CVX_SHAPES and at the pressure cut (CUT_NODES x CUT_PODS: N 16,384 x M
    2,048, the cell budget's edge), each with and without the committed
    checkpoint's duals: plans and free_after equal, feasible; the plans
    without duals at the CVX_SHAPES within EXPECTED_CVX's units."""
    from yunikorn_tpu_torch.ops import pack_solve
    from yunikorn_tpu_torch.ops.cvx_solve import cvx_solve_batch
    from yunikorn_tpu_torch.parallel.mesh import cvx_solve_sharded
    from yunikorn_tpu_torch.policy import net

    params = net.params_from_numpy(net.load_checkpoint(LEARNED_CKPT).params,
                                   dev)
    cases = [(shape, lambda shape=shape: duel_fleet(*shape)[:2])
             for shape in CVX_SHAPES]
    cases.append(((CUT_PODS, CUT_NODES, "cut"),
                  lambda: build_workload(CUT_NODES, CUT_PODS)[:2]))
    out = []
    for shape, build in cases:
        enc, batch = build()
        n = batch.num_pods
        for learned in (None, params):
            t0 = time.perf_counter()
            single = cvx_solve_batch(batch, enc.nodes, seed=DUEL_SEED,
                                     learned=learned, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sharded = cvx_solve_sharded(batch, enc.nodes, mesh,
                                        seed=DUEL_SEED, learned=learned)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            equal = (torch.equal(single.assigned, sharded.assigned)
                     and torch.equal(single.free_after, sharded.free_after)
                     and bool(sharded.feasible))
            if not equal:
                raise AssertionError(f"cvx {shape} duals={learned is not None}"
                                     f": sharded differs from single")
            u = pack_solve.packed_utilization(
                sharded.assigned[:n].cpu().numpy(),
                batch.req.astype(np.int32), batch.valid,
                cap_i=np.floor(enc.nodes.capacity_arr).astype(np.int64))
            row = {"shape": list(shape), "duals": learned is not None,
                   "equal": True, "placed": u["placed"],
                   "units": u["units_norm"], "single_s": t1 - t0,
                   "mesh_s": t2 - t1}
            want = EXPECTED_CVX.get(shape)
            if want is not None and learned is None:
                placed, units = want[1]["cvx"]
                if (u["placed"] != placed or abs(u["units_norm"] - units)
                        > DUEL_UNITS_RTOL * units):
                    raise AssertionError(f"cvx {shape}: {row} off the JAX "
                                         f"package's {want[1]['cvx']}")
            out.append(row)
    return out


def mesh_arm_cores(dev, mesh):
    """solver.policy=learned (the committed checkpoint) and
    solver.policy=optimal with pack=cvx through CoreScheduler(shard=True)
    against shard=False at the pressure cut, pod for pod; each duel
    records its arm (no "mesh" skip)."""
    from yunikorn_tpu_torch.client.synthetic import (PRESSURE_APPS,
                                                     make_pressure_nodes,
                                                     make_pressure_pods)
    from yunikorn_tpu_torch.core.scheduler import SolverOptions

    apps = [(f"app-{k}", f"root.q{k}") for k in range(len(PRESSURE_APPS))]
    out = {}
    for label, solver_kw, keys in (
            ("learned", dict(policy="learned",
                             policy_checkpoint=LEARNED_CKPT),
             ("learned_util", "learned_placed")),
            ("cvx", dict(policy="optimal", pack="cvx"),
             ("cvx_util", "cvx_placed"))):
        binds, runs = {}, {}
        for shard in (True, False):
            _, core, cb = make_core(dev, make_pressure_nodes(CUT_NODES),
                                    apps, SolverOptions(shard=shard,
                                                        **solver_kw))
            pods = make_pressure_pods(CUT_PODS)
            names = {p.uid: p.metadata.name for p in pods}
            n, cycle_s = core_cycle(core, asks_of(pods))
            check_tiers(core, f"{label} core shard={shard}")
            entry = core.metrics["last_cycle"]["default"]
            skip = entry.get("policy_skip") or entry.get("cvx_skip")
            if skip is not None or any(k not in entry for k in keys):
                raise AssertionError(f"{label} core shard={shard}: the arm "
                                     f"did not run (skip {skip})")
            if shard and (core._mesh is None
                          or core._mesh.size != mesh.size
                          or entry.get("mesh") != mesh.size):
                raise AssertionError(f"{label} core: mesh {core._mesh}, "
                                     f"entry mesh {entry.get('mesh')}")
            binds[shard] = {names[k]: v for k, v in cb.bound.items()}
            runs["mesh" if shard else "single"] = {
                "placed": n, "cycle_ms": cycle_s * 1e3,
                "solve_ms": entry.get("solve_ms"),
                "winner": entry.get("solver_policy"),
                **{k: entry.get(k) for k in keys}}
        if binds[True] != binds[False]:
            diff = sum(binds[True].get(k) != v for k, v in binds[False].items())
            raise AssertionError(f"{label}: the mesh core binds {diff} pods "
                                 "differently")
        out[label] = {"identical": True, "bound": len(binds[True]), **runs}
    return out


def mesh_checks(dev, mesh, stats, clock_hz):
    """Every check of the mesh phase over `mesh`, against the single device
    `dev`, with each part's seconds."""
    out = {"shards": mesh.size, "devices": [str(d) for d in mesh.devices]}
    seconds = {}
    for name, fn in (
            ("solve", lambda: {"solve": mesh_solve(dev, mesh, stats,
                                                   clock_hz)}),
            ("locality_topology", lambda: mesh_locality_topology(dev, mesh)),
            ("preempt_fold_pack", lambda: mesh_preempt_fold_pack(dev, mesh)),
            ("core", lambda: {"core": mesh_cores(dev, mesh)}),
            ("learned", lambda: {"learned": mesh_learned(dev, mesh, stats,
                                                         clock_hz)}),
            ("orders", lambda: {"orders": mesh_orders(dev, mesh)}),
            ("cvx", lambda: {"cvx": mesh_cvx(dev, mesh)}),
            ("arm_cores", lambda: {"arm_cores": mesh_arm_cores(dev, mesh)})):
        t0 = time.perf_counter()
        out.update(fn())
        seconds[name] = time.perf_counter() - t0
    out["part_seconds"] = seconds
    return out


def phase_mesh(dev, stats, clock_hz):
    """Node-dim sharding (parallel/mesh) on MESH_SHARDS shards of the card
    (set_mesh_devices([cuda:0] * MESH_SHARDS), restored after), every
    result held against the single-device one computed here on the card;
    with more than one card, every check again over the real cards (peer
    copies between them), the kernel's counts kept from the first run."""
    from yunikorn_tpu_torch.parallel.mesh import make_mesh
    from yunikorn_tpu_torch.utils import torchtools

    torchtools.set_mesh_devices([torch.device("cuda", 0)] * MESH_SHARDS)
    try:
        out = mesh_checks(dev, make_mesh(), stats, clock_hz)
    finally:
        torchtools.set_mesh_devices(None)
    out["cards"] = torch.cuda.device_count()
    if out["cards"] > 1:
        out["real_cards"] = mesh_checks(dev, make_mesh(), {}, clock_hz)
    return out


def profile_solve(fn, top: int = 15):
    """Device time by kernel over one run of fn, such as one warm solve
    (torch.profiler), the device-busy sum and the idle share of the
    profiled wall time. The profiler's own overhead lengthens the wall
    time; the warm solve times above are taken without it."""
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            # device-side events only (kernels, copies); the CPU-side op
            # that launched a kernel reports the same device time again
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            if dev_us > 0:
                rows.append((dev_us / 1e3, e.count, e.key[:80]))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows)
        htod = [r for r in rows if "HtoD" in r[2]]
        return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
                "htod_ms": sum(r[0] for r in htod),
                "htod_copies": sum(r[1] for r in htod),
                "top": [{"ms": ms, "count": n, "name": k}
                        for ms, n, k in rows[:top]]}
    except Exception as e:  # a measurement aid: report, never fail the run
        return {"error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="",
                        help="comma-separated phases to run after build, "
                             "to look into one phase; such a run prints no "
                             "kernels line and no ok line")
    parser.add_argument("--repeat", type=int, default=1,
                        help="runs of each --only phase in one process")
    args = parser.parse_args([] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import yunikorn_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    stats = {}
    failed = []
    phases = [("build", lambda: phase_build()),
              ("warm", lambda: phase_warm(dev, stats)),
              ("kernel", lambda: phase_kernel(dev)),
              ("cut", lambda: phase_cut(dev)),
              ("main", lambda: phase_main(dev, stats, max_sm_clock_hz())),
              ("core", lambda: phase_core(dev)),
              ("locality", lambda: phase_locality(dev, stats,
                                                  max_sm_clock_hz())),
              ("topology", lambda: phase_topology(dev, stats,
                                                  max_sm_clock_hz())),
              ("preempt", lambda: phase_preempt(dev)),
              ("gate", lambda: phase_gate(dev)),
              ("duel", lambda: phase_duel(dev, stats)),
              ("learned", lambda: phase_learned(dev, stats,
                                                max_sm_clock_hz())),
              ("train", lambda: phase_train(dev, stats)),
              ("shim", lambda: phase_shim(dev, stats)),
              ("cmd", lambda: phase_cmd()),
              ("kube", lambda: phase_kube()),
              ("admit", lambda: phase_admit()),
              ("replay", lambda: phase_replay(dev, stats)),
              ("shard", lambda: phase_shard(dev, stats)),
              ("mesh", lambda: phase_mesh(dev, stats, max_sm_clock_hz()))]
    only = [name for name in args.only.split(",") if name]
    if only:
        unknown = set(only) - {name for name, _ in phases}
        if unknown:
            parser.error(f"unknown phases {sorted(unknown)}")
        by_name = dict(phases)
        phases = [phases[0]] + [(name, by_name[name]) for name in only
                                for _ in range(args.repeat)]
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            out = fn()
            ok = True
        except Exception as e:  # every phase reports, then the script fails
            out = {"error": f"{type(e).__name__}: {e}"}
            ok = False
            failed.append(name)
            # stderr too: a reader of the run's stderr alone sees why
            print(f"chip_smoke: phase {name} failed: {out['error']}",
                  file=sys.stderr, flush=True)
        emit({"phase": name, "ok": ok, "seconds": time.perf_counter() - t0,
              **out})
        if name == "build" and not ok:
            break
    if only:
        emit({"only": only, "repeat": args.repeat, "failed": failed,
              "seconds": time.perf_counter() - t_all})
        print(card, flush=True)
        return 1 if failed else 0
    kernels = [dict(k, **stats.get(k["name"], {})) for k in KERNELS]
    emit({"seconds": time.perf_counter() - t_all})
    emit({"kernels": kernels})
    print(card, flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
