"""The port's cycle tracer: nested spans with their thread CPU and
collector pauses, the core lock's contended waits, the SI boundary's span,
the pipelined cycle's stage spans, and the pack arm's device stages.

This module imports torch and the port only, so the card's test runs where
JAX is not:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_trace.py

Without a CUDA device the card's test skips."""
import gc
import json
import threading
import time

import pytest
import torch

from yunikorn_tpu_torch.common import si
from yunikorn_tpu_torch.locking import locking
from yunikorn_tpu_torch.obs import trace

# every span the pipelined cycle opens with CycleTracer.span
STAGES = {"gate", "gate_scan", "encode", "dispatch", "materialize", "commit",
          "housekeeping", "publish"}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pack arm's stages are timed "
                    "with CUDA events, which have no CPU mode")


class _Callback:
    def update_allocation(self, r): pass
    def update_application(self, r): pass
    def update_node(self, r): pass
    def predicates(self, a): return None
    def preemption_predicates(self, a): return None
    def send_event(self, e): pass
    def update_container_scheduling_state(self, r): pass
    def get_state_dump(self): return "{}"


def make_core(device="cpu", policy="greedy", nodes=32):
    """A core with `nodes` kwok nodes and one app on root.q."""
    from yunikorn_tpu_torch.cache.external.scheduler_cache import \
        SchedulerCache
    from yunikorn_tpu_torch.client.synthetic import make_kwok_nodes
    from yunikorn_tpu_torch.core.scheduler import CoreScheduler, SolverOptions

    cache = SchedulerCache()
    core = CoreScheduler(cache, device=device,
                         solver_options=SolverOptions(policy=policy))
    core.register_resource_manager(si.RegisterResourceManagerRequest(
        rm_id="t", policy_group="queues"), _Callback())
    fleet = make_kwok_nodes(nodes)
    for n in fleet:
        cache.update_node(n)
    core.update_node(si.NodeRequest(nodes=[
        si.NodeInfo(node_id=n.name, action=si.NodeAction.CREATE)
        for n in fleet]))
    core.update_application(si.ApplicationRequest(new=[
        si.AddApplicationRequest(application_id="app", queue_name="root.q",
                                 user=si.UserGroupInfo(user="u"))]))
    return core


def asks(n, prefix="p"):
    from yunikorn_tpu_torch.client.synthetic import make_sleep_pods
    from yunikorn_tpu_torch.common.resource import get_pod_resource

    return [si.AllocationAsk(p.metadata.name, "app", get_pod_resource(p),
                             pod=p)
            for p in make_sleep_pods(n, "app", queue="root.q",
                                     name_prefix=prefix)]


def pipelined_wave(core, n=60):
    """One wave through the pipelined cycle: the tick that gates and
    dispatches it, and the tick that commits and publishes it."""
    core.update_allocation(si.AllocationRequest(asks=asks(n)))
    core._pipeline_tick()
    core._pipeline_tick()


def args(span):
    return dict(span.args)


def thread_clock_step_ms():
    """The step of the thread CPU clock on this machine, in ms: it may
    tick far more coarsely than its stated resolution."""
    t0 = time.thread_time()
    t1 = t0
    while t1 == t0:
        t1 = time.thread_time()
    return (t1 - t0) * 1e3


def test_spans_nest_on_one_thread_only():
    tr = trace.CycleTracer()
    seen = {}

    def other():
        with tr.span("elsewhere", 1):
            pass
        seen["done"] = True

    with tr.span("outer", 1):
        with tr.span("inner", 1):
            with tr.span("innermost", 1):
                pass
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen["done"]
    by = {s.name: s for s in tr.spans()}
    assert by["outer"].parent == ""
    assert by["inner"].parent == "outer"
    assert by["innermost"].parent == "inner"
    assert by["elsewhere"].parent == ""
    names = [s.name for s in tr.spans()]
    # children enter the ring before their parents
    assert names.index("innermost") < names.index("inner") < names.index(
        "outer")


def test_dropped_span_takes_its_children_but_its_pauses():
    tr = trace.CycleTracer()
    with tr.span("kept", 1):
        with tr.span("gate", 2) as gate:
            with tr.span("lock_wait", 2):
                pass
            gate.drop()
    assert [s.name for s in tr.spans()] == ["kept"]
    # an exception leaving a span drops it
    with pytest.raises(ValueError):
        with tr.span("failed", 3):
            raise ValueError
    assert [s.name for s in tr.spans()] == ["kept"]
    assert trace.inherit() == []
    tr.clear()
    with tr.span("gate", 2) as gate:
        with tr.span("gate_scan", 2):
            gc.collect()
        gate.drop()
    spans = tr.spans()
    assert spans and {s.name for s in spans} == {"gc"}
    # each pause now carries itself: its span was dropped
    for s in spans:
        assert s.parent == "gate_scan"
        assert args(s)["gc_ms"] == pytest.approx((s.t1 - s.t0) * 1e3,
                                                 abs=1e-3)


def test_explicit_ends_and_late_args():
    tr = trace.CycleTracer()
    t0 = time.time() - 1.0
    sp = tr.span("gate", 5, t0=t0, pods=3)
    sp.close(t0 + 0.5, path="host")
    (s,) = tr.spans()
    assert (s.t0, s.t1, s.cycle_id) == (t0, t0 + 0.5, 5)
    a = args(s)
    assert a["pods"] == 3 and a["path"] == "host"
    assert {"cpu_ms", "gc_ms"} <= set(a)


def test_cpu_ms_is_at_most_the_wall_time():
    tr = trace.CycleTracer()
    with tr.span("work", 1):
        busy(0.05)
        time.sleep(0.05)
    (s,) = tr.spans()
    wall_ms = (s.t1 - s.t0) * 1e3
    cpu_ms = args(s)["cpu_ms"]
    # one reading of the thread clock at each end
    tol = 2 * thread_clock_step_ms() + 1.0
    assert 50.0 - tol <= cpu_ms <= wall_ms + tol
    # the sleep is off the CPU
    assert wall_ms - cpu_ms >= 50.0 - tol


def test_collection_is_charged_to_the_open_span():
    tr = trace.CycleTracer()
    gc.collect()
    with tr.span("stage", 4):
        gc.collect()
    spans = tr.spans()
    stage = next(s for s in spans if s.name == "stage")
    kids = [s for s in spans if s.name == "gc"]
    assert args(stage)["gc_ms"] > 0.0
    assert kids and all(s.parent == "stage" and s.cycle_id == 4
                        for s in kids)
    k = args(kids[-1])
    assert k["generation"] == 2 and k["gc_ms"] == 0.0 and "cpu_ms" in k
    assert stage.t0 <= kids[-1].t0 <= kids[-1].t1 <= stage.t1
    # a collection outside any open span is counted, not charged (another
    # thread may add its own collections meanwhile)
    before = trace.gc_hook_counts()
    gc.collect()
    after = trace.gc_hook_counts()
    assert after["outside"] >= before["outside"] + 1
    assert after["calls"] >= before["calls"] + 1
    assert after["outside_ms"] > before["outside_ms"]


def test_gc_hook_is_installed_once_per_process():
    trace.CycleTracer()
    trace.CycleTracer()
    hooks = [cb for cb in gc.callbacks if isinstance(cb, trace._GcHook)]
    assert len(hooks) == 1


def busy(seconds):
    end = time.thread_time() + seconds
    while time.thread_time() < end:
        pass


def test_worker_thread_adopts_the_callers_span():
    """A worker running a span's work while the span's thread waits: its
    spans nest under the span, its pauses are charged to it, and its CPU
    time counts to the span and every span around it."""
    tr = trace.CycleTracer()
    with tr.span("dispatch", 7):
        with tr.span("pack_launch", 7):
            frames = trace.inherit()

            def job():
                with trace.adopted(frames):
                    gc.collect()
                    with tr.span("inner", 7):
                        busy(0.08)

            t = threading.Thread(target=job)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    assert trace.inherit() == []
    by = {s.name: s for s in tr.spans()}
    assert by["inner"].parent == "pack_launch"
    assert args(by["pack_launch"])["gc_ms"] > 0.0
    # the waiting thread spent little CPU of its own; each thread's clock
    # is read at both ends
    tol = 4 * thread_clock_step_ms() + 1.0
    for name in ("inner", "pack_launch", "dispatch"):
        assert args(by[name])["cpu_ms"] >= 80.0 - tol, name
        assert args(by[name])["cpu_ms"] <= (
            by[name].t1 - by[name].t0) * 1e3 + tol


def test_try_acquire_keeps_the_lock_semantics():
    m = locking.RMutex()
    assert m.try_acquire()
    assert m.try_acquire()          # reentrant on the holding thread
    got = []
    t = threading.Thread(target=lambda: got.append(m.try_acquire()))
    t.start()
    t.join(timeout=10)
    assert got == [False]
    m.release()
    m.release()
    t = threading.Thread(target=lambda: got.append(m.try_acquire()))
    t.start()
    t.join(timeout=10)
    assert got == [False, True]
    plain = locking.Mutex()
    assert plain.try_acquire() and not plain.try_acquire()
    plain.release()


def test_contended_core_lock_leaves_a_lock_wait():
    core = make_core()
    core.tracer.clear()
    core.update_allocation(si.AllocationRequest(asks=asks(3, "a")))
    assert not [s for s in core.tracer.spans() if s.name == "lock_wait"]
    t = hold_core_lock(core, 0.05)
    core.update_allocation(si.AllocationRequest(asks=asks(3, "b")))
    t.join(timeout=10)
    assert not t.is_alive()
    waits = [s for s in core.tracer.spans() if s.name == "lock_wait"]
    assert len(waits) == 1
    w = waits[0]
    assert w.parent == "si_update"
    assert (w.t1 - w.t0) * 1e3 >= 30.0
    assert args(w)["cpu_ms"] < (w.t1 - w.t0) * 1e3


def test_update_allocation_leaves_one_si_update():
    core = make_core()
    core.tracer.clear()
    core.update_allocation(si.AllocationRequest(
        asks=asks(4) + [si.AllocationAsk("x", "no-such-app", asks(1, "q")[0]
                                         .resource)]))
    ups = [s for s in core.tracer.spans() if s.name == "si_update"]
    assert len(ups) == 1
    a = args(ups[0])
    assert (a["asks"], a["releases"], a["allocations"], a["rejected"]) == (
        5, 0, 0, 1)
    assert ups[0].parent == "" and {"cpu_ms", "gc_ms"} <= set(a)


def hold_core_lock(core, seconds):
    """Hold the core lock on another thread for about `seconds`; returns
    the thread, once the lock is held."""
    held = threading.Event()

    def holder():
        with core._lock:
            held.set()
            time.sleep(seconds)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(timeout=10)
    return t


def test_one_pod_request_leaves_no_span():
    """A request of one ask (the shim's per-pod submit) takes the core lock
    with no span, free or contended, in either ring, so a submit storm
    neither pays for tracing nor evicts the cycle skeleton."""
    core = make_core()
    core.tracer.clear()
    for a in asks(3, "one"):
        core.update_allocation(si.AllocationRequest(asks=[a]))
    t = hold_core_lock(core, 0.05)
    core.update_allocation(si.AllocationRequest(asks=asks(1, "two")))
    t.join(timeout=10)
    assert not t.is_alive()
    assert core.tracer.spans() == []
    assert core.tracer.spans(pods=True) == []
    app = core.partition.applications["app"]
    assert {"one-0", "one-1", "one-2", "two-0"} <= set(app.pending_asks)


def test_pipelined_tick_leaves_its_stages_and_no_solve_span():
    core = make_core()
    core.tracer.clear()
    pipelined_wave(core)
    spans = core.tracer.spans()
    names = {s.name for s in spans}
    assert STAGES - {"housekeeping"} <= names
    assert "housekeeping" in names
    assert "solve" not in names
    parent = {s.name: s.parent for s in spans}
    assert parent["gate_scan"] == "gate"
    assert parent["gate"] == parent["encode"] == parent["commit"] == ""
    cycles = {s.cycle_id for s in spans if s.name in STAGES - {
        "housekeeping"}}
    assert len(cycles) == 1
    for s in spans:
        if s.name in STAGES:
            a = args(s)
            assert {"cpu_ms", "gc_ms"} <= set(a), s
    # the pipelined stages keep their end points
    by = {s.name: s for s in spans}
    assert by["gate"].t1 == by["encode"].t0
    assert by["materialize"].t1 == by["commit"].t0
    entry = core.metrics["last_cycle"]["default"]
    assert entry["pods"] == 60
    assert not set(entry) & {
        "pack_relax_device_ms", "pack_round_device_ms",
        "pack_gumbel_device_ms", "pack_repair_device_ms"}


def test_idle_tick_leaves_no_span():
    core = make_core()
    pipelined_wave(core)
    core._pipeline_tick()            # drains nothing: the wave committed
    core.tracer.clear()
    core._pipeline_tick()
    # a collection during the tick would still be marked
    assert [s for s in core.tracer.spans() if s.name != "gc"] == []


def test_optimal_cycle_on_the_cpu_has_no_device_fields():
    core = make_core(policy="optimal")
    core.tracer.clear()
    pipelined_wave(core)
    spans = core.tracer.spans()
    launch = [s for s in spans if s.name == "pack_launch"]
    assert len(launch) == 1 and launch[0].parent == "dispatch"
    entry = core.metrics["last_cycle"]["default"]
    assert "pack_plan_ms" in entry
    from yunikorn_tpu_torch.core.scheduler import PACK_DEVICE_KEYS

    assert not set(entry) & set(PACK_DEVICE_KEYS)
    mat = next(s for s in spans if s.name == "materialize")
    assert not set(args(mat)) & set(PACK_DEVICE_KEYS)


def test_optimal_cycle_on_the_cpu_counts_no_pick_launches():
    """The entry and the materialize span name the rounding pick kernel's
    launches in the cycle's pack solve: none off the card."""
    core = make_core(policy="optimal")
    core.tracer.clear()
    pipelined_wave(core)
    entry = core.metrics["last_cycle"]["default"]
    assert entry["pack_pick_launches"] == 0
    mat = next(s for s in core.tracer.spans() if s.name == "materialize")
    assert args(mat)["pack_pick_launches"] == 0


def test_chrome_export_loads_with_the_new_args():
    core = make_core(policy="optimal")
    core.tracer.clear()
    with core.tracer.span("outer", 0):
        gc.collect()
    pipelined_wave(core)
    doc = json.loads(json.dumps(core.tracer.chrome_trace()))
    data = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e["name"] == "thread_name"}
    assert "device: solve" not in lanes
    assert "solve" not in {e["name"] for e in data}
    for e in data:
        assert {"cycle", "parent", "cpu_ms", "gc_ms"} <= set(e["args"]), e
    tid = {e["name"]: e["tid"] for e in data}
    # a child without a lane of its own renders on its parent's
    outer_gc = [e for e in data if e["name"] == "gc"
                and e["args"]["parent"] == "outer"]
    assert outer_gc and {e["tid"] for e in outer_gc} == {
        trace._DEFAULT_LANE[1]}
    assert tid["gate_scan"] == tid["gate"] == tid["pack_launch"]
    assert tid["si_update"] == trace.LANES["si_update"][1]


@pytest.mark.cuda
def test_card_optimal_cycle_times_the_pack_stages():
    """On the card the entry of an optimal cycle, and its materialize
    span, carry the pack arm's device ms per stage; the Gumbel draws lie
    inside the rounding, and the stages inside the cycle."""
    needs_card()
    from yunikorn_tpu_torch.core.scheduler import PACK_DEVICE_KEYS

    core = make_core(device="cuda", policy="optimal", nodes=256)
    pipelined_wave(core, n=2_000)
    core.tracer.clear()
    pipelined_wave(core, n=2_000)
    entry = core.metrics["last_cycle"]["default"]
    assert set(PACK_DEVICE_KEYS) <= set(entry), entry
    ms = {k: entry[k] for k in PACK_DEVICE_KEYS}
    assert all(v > 0.0 for v in ms.values()), ms
    assert ms["pack_gumbel_device_ms"] <= ms["pack_round_device_ms"]
    assert (ms["pack_relax_device_ms"] + ms["pack_round_device_ms"]
            + ms["pack_repair_device_ms"]) <= entry["total_ms"]
    mat = next(s for s in core.tracer.spans() if s.name == "materialize")
    assert {k: args(mat)[k] for k in PACK_DEVICE_KEYS} == ms
    # one pick launch a rounding round, each inside the "gumbel" stage
    assert entry["pack_pick_launches"] == args(mat)["pack_pick_launches"] \
        == 4


@pytest.mark.cuda
def test_card_device_timer_adds_no_synchronisation(capsys):
    """One pack solve on the card synchronises with the host as often with
    its stages timed as without."""
    needs_card()
    import warnings

    from yunikorn_tpu_torch.client.synthetic import make_kwok_nodes
    from yunikorn_tpu_torch.cache.external.scheduler_cache import \
        SchedulerCache
    from yunikorn_tpu_torch.ops import assign, pack_solve
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    for node in make_kwok_nodes(128):
        cache.update_node(node)
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    batch = enc.build_batch(asks(1_024), ranks=list(range(1_024)))
    np_args, static = assign.prepare_solve_args(batch, enc.nodes)
    a, _ = assign.solve_args_from_numpy(np_args, static, "cuda")
    kw = dict(n_parts=pack_solve.pick_parts(np_args[0].shape[0],
                                            np_args[19].shape[0]),
              score_cols=static["score_cols"], device="cuda")

    def syncs(timer):
        pack_solve.pack_solve(*a, 7, timer=timer, **kw)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = pack_solve.pack_solve(*a, 7, timer=timer, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        n = sum(1 for w in caught
                if "a synchronizing CUDA operation" in str(w.message))
        return n, out

    plain, out0 = syncs(None)
    timer = trace.DeviceTimer()
    timed, out1 = syncs(timer)
    with capsys.disabled():
        print(f"\npack_solve host synchronisations: {plain} untimed, "
              f"{timed} timed")
    assert timed == plain
    assert torch.equal(out0[0], out1[0])
    torch.cuda.synchronize()
    read = timer.read()
    assert set(read) == {"relax", "round", "gumbel", "repair"}
