"""The port's device-resident state against the JAX package's: the node
mirror (snapshot/encoder.DeviceNodeState), the victim mirror, and the
solves that read them.

- Refresh modes (full / clean / fields) and the upload accounting, driven
  through both packages' encoders on the same events: the same mode, the
  same fields, the same bytes, and tensors equal bit for bit to the JAX
  package's device_arrays() / victim_arrays() arrays.
- solve_batch with device_state (and the row store's req_device) equal to
  the JAX package's solve_batch with its own mirror on the pressure,
  locality, topology and host-port (bypass) batches, and to the port's own
  host-array solve in all five outputs; the mirror tensors untouched.
- Device preemption plans read from the victim mirror equal the host
  planner's.
- The epoch fence (MirrorDiscarded), the core's clean warm solve, and an
  abandoned dispatch orphaning the mirror.
"""
import dataclasses
import importlib
import random
import time

import numpy as np
import pytest
import torch

from test_torch_core import PORT, REF, Env
from test_torch_encoder import build_mixed, build_pressure
from test_torch_locality import Pkg, fuzz_batch
from test_torch_preempt_solve import cluster, plans_key
from test_torch_topology import make_cluster, steered
from yunikorn_tpu.ops import assign as jassign
from yunikorn_tpu_torch.ops import assign as tassign
from yunikorn_tpu_torch.robustness import supervisor as tsup
from yunikorn_tpu_torch.snapshot import encoder as tenc


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def as_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mirror_dict(pkg, enc, victims=False):
    """The package's refreshed mirror as numpy arrays (bitsets as uint32
    on both sides: the port keeps int32 views of the same bits)."""
    if pkg == REF:
        arrays = enc.victim_arrays() if victims else enc.device_arrays()
    elif victims:
        arrays = enc.victim_arrays(device="cpu")
    else:
        arrays = enc.device_arrays(device="cpu")
    out = {}
    for k, v in arrays.items():
        a = as_np(v)
        out[k] = a.view(np.uint32) if k in ("labels", "taints_hard",
                                            "taints_soft", "ports") else a
    return out


def assert_mirrors_equal(enc_j, enc_t, victims=False):
    want, got = mirror_dict(REF, enc_j, victims), mirror_dict(PORT, enc_t,
                                                              victims)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    dj, dt = enc_j.device, enc_t.device
    assert (dj.last_refresh, dj.last_fields) == (dt.last_refresh,
                                                 dt.last_fields)
    if victims:
        assert dj.last_victim_refresh == dt.last_victim_refresh
    assert dj.take_upload_bytes() == dt.take_upload_bytes()
    return dt.last_refresh


# --------------------------------------------------------------------------
# the node mirror
# --------------------------------------------------------------------------

class Churn:
    """One cluster through package pkg, and the events of a churn trace:
    nodes with labels, taints and host-port pods, pod churn, a cordon, a
    node removal and capacity growth."""

    def __init__(self, pkg):
        self.o = _mod(pkg, "common.objects")
        self.cache = _mod(pkg, "cache.external.scheduler_cache").SchedulerCache()
        self.enc = _mod(pkg, "snapshot.encoder").SnapshotEncoder(self.cache)

    def node(self, i, **kw):
        o = self.o
        n = o.make_node(f"m{i}", cpu_milli=2000 + 100 * i, memory=2**30,
                        labels={"zone": f"z{i % 3}", "k": str(i)}, **kw)
        if i % 4 == 1:
            n.spec.taints = [o.Taint("t", "1", "NoSchedule")]
        if i % 4 == 2:
            n.spec.taints = [o.Taint("s", "1", "PreferNoSchedule")]
        self.cache.update_node(n)
        return n

    def pod(self, name, node, port=None):
        p = self.o.make_pod(name, cpu_milli=300, memory=2**20,
                            node_name=node, phase="Running")
        if port is not None:
            p.spec.containers[0].ports = [{"hostPort": port,
                                           "protocol": "TCP"}]
        self.cache.update_pod(p)
        return p


def churn_steps(c, rng):
    """The steps of one churn trace (each ends in a sync_nodes)."""
    yield lambda: [c.node(i) for i in range(6)]
    yield lambda: None                                     # clean
    pods = []
    yield lambda: pods.extend(c.pod(f"p{i}", f"m{i % 6}",
                                    port=8000 + i if i % 3 == 0 else None)
                              for i in range(5))
    yield lambda: c.cache.remove_pod(pods.pop(rng.randrange(len(pods))))
    yield lambda: c.node(3, unschedulable=True)            # node object
    yield lambda: c.cache.remove_node("m5")
    yield lambda: None
    yield lambda: [c.node(100 + i) for i in range(130)]    # capacity grows


@pytest.mark.parametrize("seed", range(3))
def test_mirror_equals_the_reference_mirror(seed):
    """Every step of the churn trace: the port's mirror tensors equal the
    JAX package's arrays bit for bit, with the same refresh mode, fields and
    upload bytes."""
    cj, ct = Churn(REF), Churn(PORT)
    modes = []
    for sj, st in zip(churn_steps(cj, random.Random(seed)),
                      churn_steps(ct, random.Random(seed))):
        sj(), st()
        cj.enc.sync_nodes()
        ct.enc.sync_nodes()
        modes.append(assert_mirrors_equal(cj.enc, ct.enc))
    assert modes == ["full", "clean", "fields", "fields", "fields", "fields",
                     "clean", "full"]


def test_refresh_modes_and_upload_accounting():
    """tests/test_incremental_encoder.py's refresh-mode contract on the
    port: clean cycles re-use the tensors outright (0 bytes), pod churn
    re-uploads only free_i and ports, growth re-uploads everything; a
    refresh swaps in new tensors and never writes into old ones."""
    c = Churn(PORT)
    for i in range(4):
        c.node(i)
    enc = c.enc
    enc.sync_nodes()
    first = enc.device_arrays(device="cpu")
    dev = enc.device
    assert dev.last_refresh == "full"
    full_bytes = dev.take_upload_bytes()
    assert full_bytes == sum(v.numel() * v.element_size()
                             for v in first.values())
    again = enc.device_arrays(device="cpu")
    assert dev.last_refresh == "clean" and dev.take_upload_bytes() == 0
    assert all(again[k] is first[k] for k in first)
    snapshot = {k: v.clone() for k, v in first.items()}
    c.pod("mp0", "m0")
    enc.sync_nodes()
    churned = enc.device_arrays(device="cpu")
    assert (dev.last_refresh, dev.last_fields) == ("fields",
                                                   ("free_i", "ports"))
    assert dev.take_upload_bytes() == (churned["free_i"].numel() * 4
                                       + churned["ports"].numel() * 4)
    assert churned["free_i"] is not first["free_i"]
    assert churned["labels"] is first["labels"]
    for k in first:   # the tensors an earlier solve held never changed
        assert torch.equal(first[k], snapshot[k])
    assert not torch.equal(churned["free_i"], first["free_i"])
    for i in range(130):
        c.node(200 + i)
    enc.sync_nodes()
    enc.device_arrays(device="cpu")
    assert dev.last_refresh == "full"


def test_mirror_follows_its_device():
    """A refresh for another device re-uploads everything there."""
    c = Churn(PORT)
    c.node(0)
    c.enc.sync_nodes()
    c.enc.device_arrays(device="cpu")
    c.enc.device_arrays(device="cpu")
    assert c.enc.device.last_refresh == "clean"
    c.enc.device.refresh(torch.device("meta"))
    assert c.enc.device.last_refresh == "full"
    assert c.enc.device_arrays(device="cpu")["free_i"].device.type == "cpu"
    assert c.enc.device.last_refresh == "full"


def test_failed_upload_forces_a_full_refresh(monkeypatch):
    c = Churn(PORT)
    c.node(0)
    c.enc.sync_nodes()
    c.enc.device_arrays(device="cpu")
    c.pod("x", "m0")
    c.enc.sync_nodes()

    def broken(arr, device):
        raise RuntimeError("CUDA error: injected upload failure")

    monkeypatch.setattr(tenc, "_upload", broken)
    with pytest.raises(RuntimeError, match="injected"):
        c.enc.device_arrays(device="cpu")
    monkeypatch.undo()
    c.enc.device_arrays(device="cpu")
    assert c.enc.device.last_refresh == "full"


def test_topo_field():
    """tests/test_topology.py's contract: the mirror carries the [M, 3]
    topo coordinates, equal to the host array; a clean refresh re-uses
    them."""
    _cache, enc = make_cluster(PORT, n_nodes=8, domains=2)
    arrays = enc.device_arrays(device="cpu")
    np.testing.assert_array_equal(arrays["topo"].numpy(), enc.nodes.topo)
    assert arrays["topo"].dtype == torch.int32
    enc.device_arrays(device="cpu")
    assert enc.device.last_refresh == "clean"
    _cache_j, enc_j = make_cluster(REF, n_nodes=8, domains=2)
    np.testing.assert_array_equal(np.asarray(enc_j.device_arrays()["topo"]),
                                  arrays["topo"].numpy())


# --------------------------------------------------------------------------
# the victim mirror
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_victim_mirror_equals_the_reference(seed):
    """victim_arrays after sync_victims: the victim tables and node fields
    equal the JAX package's; an unchanged second call is clean; a victim
    table change re-uploads the group."""
    envs = {}
    for pkg in (REF, PORT):
        cache, enc, asks, app_of_pod = cluster(pkg, seed)
        enc.sync_victims(app_of_pod, cache.get_priority_class)
        envs[pkg] = (cache, enc, app_of_pod)
    (_, enc_j, _), (_, enc_t, _) = envs[REF], envs[PORT]
    assert_mirrors_equal(enc_j, enc_t, victims=True)
    assert enc_t.device.last_victim_refresh == "full"
    assert_mirrors_equal(enc_j, enc_t, victims=True)
    assert enc_t.device.last_victim_refresh == "clean"
    # the allocation path never uploads the victim group
    assert "victim_req" not in enc_t.device_arrays(device="cpu")
    for pkg, (cache, enc, app_of_pod) in envs.items():
        victim = next(p for p in cache.get_node("n000").pods.values())
        cache.remove_pod(victim)
        enc.sync_nodes()
        enc.sync_victims(app_of_pod, cache.get_priority_class)
    assert_mirrors_equal(enc_j, enc_t, victims=True)
    assert enc_t.device.last_victim_refresh == "full"


@pytest.mark.parametrize("seed", range(4))
def test_device_plans_from_the_victim_mirror_equal_the_host(seed):
    """plan_preemptions_batched (dispatch through the victim mirror) plans
    victim for victim as the host planner; the second dispatch finds the
    mirror clean and plans the same."""
    pre = _mod(PORT, "core.preemption")
    cache, enc, asks, app_of_pod = cluster(PORT, seed)
    cands = list(cache.node_names())
    host, host_att = pre.plan_preemptions(cache, asks, app_of_pod,
                                          candidate_nodes=cands)
    for expect_refresh in ("full", "clean"):
        plans, att, stats = pre.plan_preemptions_batched(
            cache, enc, asks, app_of_pod, candidate_nodes=cands, device="cpu")
        assert plans_key(plans) == plans_key(host) and att == host_att
        assert stats["victim_refresh"] == expect_refresh
        if expect_refresh == "clean":
            assert stats["mirror_upload_bytes"] == 0
    assert plans


# --------------------------------------------------------------------------
# solves on the mirror
# --------------------------------------------------------------------------

def pressure(pkg):
    enc, batch, asks = build_pressure(pkg, n_nodes=40, n_pods=300)
    return enc, batch, asks, {}


def pressure_overlays(pkg):
    """The pressure batch with the core's three overlays: an in-flight free
    delta, a partition mask and in-flight host ports."""
    enc, batch, asks, _ = pressure(pkg)
    na = enc.nodes
    delta = np.zeros((na.capacity, enc.vocabs.resources.num_slots),
                     np.float32)
    delta[:10, 0] = 5000.5
    mask = np.ones((na.capacity,), bool)
    mask[3:9] = False
    ports = np.zeros(na.ports.shape, np.uint32)
    ports[:4, 0] = 1
    return enc, batch, asks, dict(free_delta=delta, node_mask=mask,
                                  ports_delta=ports)


def chunked(pkg):
    enc, batch, asks, _ = pressure(pkg)
    return enc, batch, asks, dict(max_batch=64)


def host_ports(pkg):
    enc, batch, asks = build_mixed(pkg, n_nodes=20, n_pods=60)
    assert batch.g_ports.any()
    return enc, batch, asks, {}


def locality(pkg):
    enc, batch = fuzz_batch(Pkg(pkg), 2)
    return enc, batch, None, {}


def topology(pkg):
    enc, batch = steered(pkg)
    return enc, batch, None, {}


BATCHES = {f.__name__: f for f in (pressure, pressure_overlays, chunked,
                                   host_ports, locality, topology)}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_solve_on_the_mirror_equals_the_reference(case):
    enc_j, batch_j, _, kw = BATCHES[case](REF)
    enc_t, batch_t, asks_t, kw_t = BATCHES[case](PORT)
    want = jassign.solve_batch(batch_j, enc_j.nodes,
                               device_state=enc_j.device_arrays(), **kw)
    state = enc_t.device_arrays(device="cpu")
    before = {k: v.clone() for k, v in state.items()}
    if asks_t is not None:
        batch_t.req_device = enc_t.device_req(asks_t, batch_t, device="cpu")
        assert batch_t.req_device is not None
    got = tassign.solve_batch(batch_t, enc_t.nodes, device="cpu",
                              device_state=state, **kw_t)
    for name in ("assigned", "accept_round", "free_after"):
        np.testing.assert_array_equal(as_np(getattr(want, name)),
                                      as_np(getattr(got, name)), err_msg=name)
    assert int(want.rounds) == got.rounds
    # the host-array solve of the same batch: all five outputs
    batch_t.req_device = None
    host = tassign.solve_batch(batch_t, enc_t.nodes, device="cpu", **kw_t)
    for name in ("assigned", "accept_round", "free_after", "cnt_final"):
        a, b = getattr(host, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    assert host.rounds == got.rounds
    for k, v in state.items():   # the solve never wrote into the mirror
        assert torch.equal(v, before[k]), k


def test_req_device_only_on_the_mirror_path():
    """The row store's tensor replaces the host req only on the mirror path
    and only for a batch solved in one piece."""
    enc, batch, asks = build_pressure(PORT, n_nodes=40, n_pods=300)
    batch.req_device = enc.device_req(asks, batch, device="cpu")
    state = enc.device_arrays(device="cpu")
    np_args, _ = tassign.prepare_solve_args(batch, enc.nodes,
                                            device_state=state)
    assert np_args[0] is batch.req_device
    for kw in (dict(device_state=None),
               dict(device_state=state, allow_req_device=False)):
        np_args, _ = tassign.prepare_solve_args(batch, enc.nodes, **kw)
        assert isinstance(np_args[0], np.ndarray)
    mixed_enc, mixed_batch, mixed_asks = build_mixed(PORT, n_nodes=20,
                                                     n_pods=60)
    mixed_batch.req_device = mixed_enc.device_req(mixed_asks, mixed_batch,
                                                  device="cpu")
    np_args, _ = tassign.prepare_solve_args(
        mixed_batch, mixed_enc.nodes,
        device_state=mixed_enc.device_arrays(device="cpu"))
    assert isinstance(np_args[0], np.ndarray)   # host ports bypass it
    assert isinstance(np_args[tassign.SOLVE_ARG_NAMES.index("free")],
                      np.ndarray)


# --------------------------------------------------------------------------
# the epoch fence and the core
# --------------------------------------------------------------------------

def test_stale_epoch_raises_mirror_discarded():
    c = Churn(PORT)
    c.node(0)
    enc = c.enc
    enc.sync_nodes()
    epoch = enc.mirror_epoch
    enc.device_arrays(device="cpu", epoch=epoch)
    old = enc.device
    enc.discard_device_mirror()
    assert old.dead and enc.device is None and enc.mirror_epoch == epoch + 1
    for call in (lambda: enc.device_arrays(device="cpu", epoch=epoch),
                 lambda: enc.victim_arrays(device="cpu", epoch=epoch),
                 lambda: enc.ensure_mirror_epoch(epoch),
                 lambda: old.refresh("cpu")):
        with pytest.raises(tenc.MirrorDiscarded):
            call()
    assert enc.device is None   # a stale call never installs a mirror
    enc.device_arrays(device="cpu", epoch=enc.mirror_epoch)
    assert enc.device is not old and enc.device.last_refresh == "full"


def test_core_warm_solve_reads_a_clean_mirror():
    """Through the core: the first solve uploads the whole mirror, a warm
    solve with no node change uploads nothing (clean), and a pod landing
    in the cache re-uploads only free_i and ports. The row store ships each
    new ask's row once."""
    e = Env(PORT, None, nodes=2)
    e.add_app("app-1")
    last = lambda: e.core.metrics["last_cycle"]["default"]  # noqa: E731
    e.submit([e.ask("app-1", f"a{i}", mem=2**20) for i in range(2)])
    assert e.core.schedule_once() == 2
    assert last()["node_refresh"] == "full" and last()["node_upload_bytes"] > 0
    assert last()["encode_device_rows"] == 2
    e.submit([e.ask("app-1", f"b{i}", mem=2**20) for i in range(2)])
    assert e.core.schedule_once() == 2
    assert (last()["node_refresh"], last()["node_upload_bytes"]) == ("clean",
                                                                     0)
    assert last()["encode_device_rows"] == 2
    e.cache.update_pod(e.objects.make_pod("bound", cpu_milli=500,
                                          node_name="node-0",
                                          phase="Running"))
    e.submit([e.ask("app-1", f"c{i}", mem=2**20) for i in range(2)])
    assert e.core.schedule_once() == 2
    assert last()["node_refresh"] == "fields"
    assert e.core.encoder.device.last_fields == ("free_i", "ports")
    assert (e.core.metrics["device_transfer_bytes_total"]
            > last()["node_upload_bytes"] > 0)


def test_core_failing_mirror_refresh_fails_the_cycle(monkeypatch):
    """A mirror refresh failing on every attempt fails the cycle's solve
    (retried, then AllTiersFailed): no per-cycle upload stands in."""
    e = Env(PORT, None, nodes=2)
    e.core.supervisor.options.backoff_base_s = 0.0
    e.core.supervisor.options.probe_interval_s = 0.0  # next cycle probes
    e.add_app("app-1")
    real = tenc.DeviceNodeState.refresh

    def broken(self, device):
        raise RuntimeError("CUDA error: injected mirror upload failure")

    monkeypatch.setattr(tenc.DeviceNodeState, "refresh", broken)
    e.submit([e.ask("app-1", f"a{i}", mem=2**20) for i in range(2)])
    with pytest.raises(tsup.AllTiersFailed):
        e.core.schedule_once()
    assert e.cb.allocations == []
    assert e.core.metrics["scheduling_cycle_failures_total"] == {
        "stage=sequential": 1}
    monkeypatch.setattr(tenc.DeviceNodeState, "refresh", real)
    assert e.core.schedule_once() == 2


def test_abandoned_dispatch_orphans_the_mirror():
    """tests/test_solver_chaos.py's contract on the port: a dispatch that
    blows its deadline is abandoned, the mirror it may still touch is
    orphaned (flagged dead, replaced, epoch bumped) and the cycle fails;
    the zombie bails on the stale epoch once it unwedges, and the next
    cycle places on a fresh mirror with one full upload."""
    e = Env(PORT, None, nodes=2)
    e.core.supervisor.options.probe_interval_s = 0.0  # next cycle probes
    e.add_app("app-1")
    e.submit([e.ask("app-1", f"w{i}", mem=2**20) for i in range(2)])
    assert e.core.schedule_once() == 2
    dev0, epoch0 = e.core.encoder.device, e.core.encoder.mirror_epoch
    assert dev0 is not None and not dev0.dead
    sup = e.core.supervisor
    sup.options = dataclasses.replace(sup.options, deadline_s=0.3,
                                      max_retries=0, breaker_threshold=100)
    sup.faults.slow("assign", seconds=1.0, times=1)
    e.submit([e.ask("app-1", f"x{i}", mem=2**20) for i in range(2)])
    with pytest.raises(tsup.AllTiersFailed):
        e.core.schedule_once()
    assert dev0.dead and e.core.encoder.device is not dev0
    assert e.core.encoder.mirror_epoch > epoch0
    time.sleep(1.1)   # the zombie unwedges and bails on its stale epoch
    assert e.core.encoder.device is None
    assert e.core.schedule_once() == 2
    fresh = e.core.encoder.device
    assert fresh is not dev0 and not fresh.dead
    assert e.core.metrics["last_cycle"]["default"]["node_refresh"] == "full"
