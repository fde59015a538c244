"""yunikorn-scheduler binary.

Role-equivalent to pkg/cmd/shim/main.go:38-70: bootstrap configmaps, start the
core in-process, create + run the shim, expose the REST API, wait for
SIGINT/SIGTERM. The cluster backend is the in-memory FakeCluster (default,
also the kwok-style perf mode) or, with --kubeconfig, a cluster's API server
through the client/kube reflectors over HTTP.

Usage:
    python -m yunikorn_tpu_torch.cmd.scheduler [--nodes N] [--rest-port P]
        [--kubeconfig PATH] [--pods N] [--policy greedy|optimal|learned|all]
        [--policy-checkpoint PREFIX] [--shards N]
        [--shard-epoch-seconds S] [--ledger-serve | --ledger-endpoint H:P]

The JAX package's cmd/scheduler.py, ported. The core runs on the card:
main(argv, device=None) passes `device` to it, so the command line always
runs on `cuda` and raises without a CUDA device; device="cpu" (a caller's
choice, as the tests make it) runs the plain PyTorch path. The flags are
the JAX binary's; those whose feature the port lacks raise
NotImplementedError naming their ROADMAP item before the core is built:
--aot-store (also from $YK_AOT_STORE or conf solver.aotStore) and
--prewarm (item 15, the warm-start layer). --kubeconfig reads the
yunikorn-defaults and yunikorn-configs configmaps first, then schedules the
cluster's pods onto its nodes (--nodes and --pods are ignored there).
--shards N >= 2 builds the sharded front end
(core/shard.py) over N port cores on the one device, coupled through the
exact global quota ledger; --ledger-serve puts that ledger behind a local
socket and --ledger-endpoint couples to one in another process
(core/ledger_service.py).
--policy optimal runs the duel of the pack arm (or, with conf
solver.pack=cvx, the cvx arm) against the greedy plan on the core's
device; --policy learned the learned arm's (the two-tower scorer of the
checkpoint --policy-checkpoint names, or conf solver.policyCheckpoint),
and --policy all every arm's. One flag
is the port's own: --pods streams synthetic sleep pods into the fake
cluster after startup, so the kwok-style mode has work to schedule.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from yunikorn_tpu_torch.cache.context import Context
from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
from yunikorn_tpu_torch.client.fake import FakeCluster
from yunikorn_tpu_torch.client.synthetic import make_kwok_nodes, make_sleep_pods
from yunikorn_tpu_torch.conf.schedulerconf import get_holder
from yunikorn_tpu_torch.log.logger import log
from yunikorn_tpu_torch.ops.assign import not_ported
from yunikorn_tpu_torch.shim.scheduler import KubernetesShim
from yunikorn_tpu_torch.webapp.rest import RestServer

logger = log("shim")

# --pods arrive in waves of this many pods, one wave a second
POD_WAVE = 200


def _check_flags(args, conf) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for each flag (or
    configmap key) whose feature the port does not have yet."""
    if args.aot_store or conf.solver_aot_store:
        not_ported("--aot-store", 15, "warm-start layer")
    if args.prewarm:
        not_ported("--prewarm", 15, "warm-start layer")


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(description="yunikorn scheduler on the card")
    parser.add_argument("--nodes", type=int, default=0,
                        help="pre-create N synthetic kwok-style nodes")
    parser.add_argument("--rest-port", type=int, default=9080)
    parser.add_argument("--pods", type=int, default=0,
                        help="after startup, add N synthetic sleep pods in "
                             "5 queues (root.q0..q4) to the fake cluster, "
                             f"{POD_WAVE} a second")
    parser.add_argument("--queues-yaml", type=str, default="",
                        help="path to a queues.yaml config file")
    parser.add_argument("--kubeconfig", type=str, default="",
                        help="schedule against a real cluster via this "
                             "kubeconfig (kind/kwok); default: FakeCluster")
    parser.add_argument("--prewarm", type=str, default="",
                        help="warm standard solve buckets at startup, e.g. "
                             "'1024x4096,16384x65536' (nodes x pods): not "
                             "ported yet (ROADMAP item 15)")
    parser.add_argument("--aot-store", type=str,
                        default=os.environ.get("YK_AOT_STORE", ""),
                        help="prebuilt executable store directory (default "
                             "$YK_AOT_STORE, else conf solver.aotStore): not "
                             "ported yet (ROADMAP item 15)")
    parser.add_argument("--trace-out", type=str, default="",
                        help="dump the cycle tracer as Chrome trace-event "
                             "JSON to this path at shutdown (the live ring "
                             "is always available at /debug/traces)")
    parser.add_argument("--shards", type=str, default="",
                        help="control-plane shards (core/shard.py): 'auto' "
                             "or a count in [1, 64]. N >= 2 runs N pipelined "
                             "CoreScheduler shards over disjoint topology-"
                             "aligned node partitions, coupled through the "
                             "exact global quota ledger + stranded-ask "
                             "repair. Default: conf solver.shards (auto=1)")
    parser.add_argument("--policy", type=str, default="",
                        choices=("", "greedy", "optimal", "learned", "all"),
                        help="solver.policy override: greedy; optimal "
                             "(the pack or cvx arm dueling the greedy plan; "
                             "conf solver.pack picks the arm); learned (the "
                             "two-tower scorer's plan dueling it); all (every "
                             "arm). Unknown values reject here, matching the "
                             "configmap validation")
    parser.add_argument("--policy-checkpoint", type=str, default="",
                        help="learned-policy checkpoint prefix (the "
                             "<prefix>.npz + <prefix>.json pair). Default: "
                             "conf solver.policyCheckpoint. A checkpoint "
                             "that fails validation is rejected "
                             "(policy_checkpoint_rejected_total) and the "
                             "learned arm skips")
    parser.add_argument("--shard-epoch-seconds", type=float, default=0.0,
                        help="re-seed the shard partition every N seconds "
                             "(0 = never): moved ICI domains migrate "
                             "between shards so fragmentation cannot "
                             "ossify")
    parser.add_argument("--ledger-endpoint", type=str, default="",
                        help="couple the sharded control plane to a quota "
                             "ledger served at host:port in ANOTHER "
                             "process (core/ledger_service.py): every "
                             "reserve/confirm/release rides the RPC "
                             "boundary with deadlines, idempotent replay, "
                             "circuit breaker and degraded-mode admission. "
                             "Default: conf solver.ledgerEndpoint; empty = "
                             "in-process direct ledger")
    parser.add_argument("--ledger-serve", action="store_true",
                        help="host the ledger authority behind a local "
                             "socket in THIS process and couple the shards "
                             "through LedgerClient anyway (the single-box "
                             "service shape; peers join via "
                             "--ledger-endpoint). Requires --shards >= 2")
    args = parser.parse_args(argv)

    # The JAX binary seeds its persistent compilation cache here; the port's
    # kernels build at the core's first solve and their libraries are cached
    # by source hash. A warm-start layer is ROADMAP item 15.

    queues_yaml = ""
    if args.queues_yaml:
        with open(args.queues_yaml) as f:
            queues_yaml = f.read()
    holder = get_holder()
    if args.kubeconfig:
        if args.nodes or args.pods:
            logger.warning("--nodes and --pods are ignored with --kubeconfig "
                           "(nodes and pods come from the cluster)")
        # real cluster: bootstrap configmaps BEFORE informers, then build the
        # provider from the bootstrapped conf (QPS/DRA may come from the
        # cluster's configmaps) — reference client/bootstrap.go:28 ordering
        from yunikorn_tpu_torch.client.kube import (
            KubeConfig, RealAPIProvider, RealKubeClient,
            load_bootstrap_configmaps)

        kc = KubeConfig.load(args.kubeconfig)
        maps, binary_maps = load_bootstrap_configmaps(
            RealKubeClient(kc), holder.get().namespace)
        if queues_yaml:
            maps.append({"queues.yaml": queues_yaml})
            binary_maps.append({})
        holder.update_config_maps(maps, initial=True, binary_maps=binary_maps)
        _check_flags(args, holder.get())
        conf0 = holder.get()
        cluster = RealAPIProvider(kc, qps=conf0.kube_qps,
                                  burst=conf0.kube_burst,
                                  enable_dra=conf0.enable_dra,
                                  namespace=conf0.namespace)
    else:
        holder.update_config_maps([{"queues.yaml": queues_yaml}],
                                  initial=True)
        _check_flags(args, holder.get())
        cluster = FakeCluster()
        if args.nodes:
            for node in make_kwok_nodes(args.nodes):
                cluster.add_node(node)

    from yunikorn_tpu_torch.core.ledger_service import LedgerClientOptions
    from yunikorn_tpu_torch.core.scheduler import SolverOptions
    from yunikorn_tpu_torch.core.shard import (make_core_scheduler,
                                               resolve_shards)
    from yunikorn_tpu_torch.obs.flightrec import FlightRecorderOptions
    from yunikorn_tpu_torch.obs.slo import SloOptions
    from yunikorn_tpu_torch.robustness.failover import FailoverOptions
    from yunikorn_tpu_torch.robustness.supervisor import SupervisorOptions

    cache = SchedulerCache()
    solver_opts = SolverOptions.from_conf(holder.get())
    if args.policy:
        solver_opts.policy = args.policy
    if args.policy_checkpoint:
        solver_opts.policy_checkpoint = args.policy_checkpoint
    n_shards = resolve_shards(args.shards or holder.get().solver_shards)
    ledger_endpoint = (args.ledger_endpoint
                       or holder.get().solver_ledger_endpoint)
    core = make_core_scheduler(
        cache, shards=n_shards,
        solver_options=solver_opts,
        trace_spans=holder.get().obs_trace_spans,
        supervisor_options=SupervisorOptions.from_conf(holder.get()),
        slo_options=SloOptions.from_conf(holder.get()),
        epoch_seconds=args.shard_epoch_seconds,
        failover_options=FailoverOptions.from_conf(holder.get()),
        journey_capacity=holder.get().obs_journey_capacity,
        flightrec_options=FlightRecorderOptions.from_conf(holder.get()),
        delivery_high_water=holder.get().solver_delivery_high_water,
        ledger_endpoint=ledger_endpoint, ledger_serve=args.ledger_serve,
        ledger_client_options=LedgerClientOptions.from_conf(holder.get()),
        device=device)
    if n_shards > 1:
        logger.info("control-plane sharding: %d shards (epoch %ss, "
                    "failover stale budget %ss)",
                    n_shards, args.shard_epoch_seconds or "off",
                    holder.get().robustness_failover_stale_s)
        if args.ledger_serve:
            logger.info("ledger service: authority on %s (fail-closed=%s)",
                        core.ledger_server.endpoint,
                        holder.get().robustness_ledger_fail_closed)
        elif ledger_endpoint:
            logger.info("ledger service: coupling to remote authority at "
                        "%s", ledger_endpoint)
    context = Context(cluster, core, cache=cache)
    shim = KubernetesShim(cluster, core, context=context)
    rest = RestServer(core, context, port=args.rest_port)

    core.start()
    shim.run()
    port = rest.start()
    logger.info("scheduler up; REST on :%d; device=%s", port, core.device)

    stop = threading.Event()

    def handle_signal(signum, frame):
        logger.info("signal %s received, shutting down", signum)
        stop.set()

    signal.signal(signal.SIGINT, handle_signal)
    signal.signal(signal.SIGTERM, handle_signal)
    feeder = None
    if args.pods and not args.kubeconfig:
        feeder = threading.Thread(
            target=_feed_pods, args=(cluster, args.pods, stop),
            name="pod-feeder", daemon=True)
        feeder.start()
    stop.wait()
    if feeder is not None:
        feeder.join()
    rest.stop()
    core.stop()   # before the shim: no callbacks into a stopped dispatcher
    shim.stop()
    if args.trace_out:
        import json

        with open(args.trace_out, "w") as f:
            json.dump(core.tracer.chrome_trace(), f)
        logger.info("cycle trace written to %s", args.trace_out)
    return 0


def _feed_pods(cluster, n_pods: int, stop) -> None:
    """Add n_pods synthetic sleep pods (5 apps, one per queue root.q0..q4)
    to the fake cluster, POD_WAVE a second, until stop."""
    pods = [pod for q in range(5) for pod in make_sleep_pods(
        n_pods // 5 + (q < n_pods % 5), f"cmd-app-{q}", queue=f"root.q{q}",
        name_prefix=f"q{q}")]
    for k in range(0, len(pods), POD_WAVE):
        if k and stop.wait(1.0):
            return
        for pod in pods[k:k + POD_WAVE]:
            cluster.add_pod(pod)
    logger.info("%d synthetic pods added", len(pods))


if __name__ == "__main__":
    sys.exit(main())
