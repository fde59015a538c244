"""The device-resident state and the device gate on the card against the
same code on the CPU: the node and victim mirrors, the gate scan and its
host synchronisations, the row quantization (saturation past 2^31
included), and a warm solve on a clean mirror uploading nothing.

This module imports torch, numpy and the port only, so it runs where the
card is and JAX is not:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_device_state_card.py

Without a CUDA device every test skips."""
import warnings

import numpy as np
import pytest
import torch

from test_torch_core import PORT, Env
from yunikorn_tpu_torch.client import synthetic as tsyn
from yunikorn_tpu_torch.core.gate import extract_problem, host_scan
from yunikorn_tpu_torch.ops import gate_solve as tgs
from yunikorn_tpu_torch.ops.assign import solve_batch


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mirror, the scan and the row "
                    "store live on it")


def pressure_encoder(n_nodes=200, n_pods=1_000):
    from yunikorn_tpu_torch.cache.external.scheduler_cache import SchedulerCache
    from yunikorn_tpu_torch.common.resource import get_pod_resource
    from yunikorn_tpu_torch.common.si import AllocationAsk
    from yunikorn_tpu_torch.snapshot.encoder import SnapshotEncoder

    cache = SchedulerCache()
    for node in tsyn.make_pressure_nodes(n_nodes):
        cache.update_node(node)
    pods = tsyn.make_pressure_pods(n_pods)
    asks = [AllocationAsk(p.uid, p.metadata.labels["applicationId"],
                          get_pod_resource(p), pod=p) for p in pods]
    enc = SnapshotEncoder(cache)
    enc.sync_nodes(full=True)
    return cache, enc, enc.build_batch(asks, ranks=list(range(len(asks)))), \
        asks


def gate_problems(n=2_000):
    out = []
    for scale in tsyn.GATE_SHAPES.values():
        tree = tsyn.build_gate_tree(n, scale=scale)
        by_queue = tsyn.build_gate_trace(tree, n)
        out.append(extract_problem(by_queue, tsyn.gate_meta_for(tree, by_queue),
                                   tree))
    return out


def count_syncs(fn):
    """(fn's result, the synchronising CUDA operations it made)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


@pytest.mark.cuda
def test_card_mirror_equals_the_cpu_mirror():
    needs_card()
    cache, enc, _batch, _asks = pressure_encoder()
    card = {k: v.cpu() for k, v in enc.device_arrays(device="cuda").items()}
    assert enc.device.last_refresh == "full"
    assert all(v.device.type == "cuda"
               for v in enc.device_arrays(device="cuda").values())
    assert enc.device.last_refresh == "clean"
    host = enc.device_arrays(device="cpu")
    for k in card:
        assert torch.equal(card[k], host[k]), k
    from yunikorn_tpu_torch.common.objects import make_pod

    app_of_pod = {}
    for i in range(20):
        v = make_pod(f"v{i}", cpu_milli=500, node_name=f"kwok-node-{i}",
                     phase="Running", priority=i % 3)
        cache.update_pod(v)
        app_of_pod[v.uid] = "victims"
    enc.sync_nodes()
    enc.sync_victims(app_of_pod, cache.get_priority_class)
    card = {k: v.cpu() for k, v in enc.victim_arrays(device="cuda").items()}
    host = enc.victim_arrays(device="cpu")
    assert sorted(card) == sorted(host)
    for k in card:
        assert torch.equal(card[k], host[k]), k


@pytest.mark.cuda
def test_card_gate_scan_equals_cpu_and_syncs_once_a_pass():
    """The scan on the card: the CPU's row status and pass count on both
    dtype paths, at most passes + 1 host synchronisations, and
    device_admit equal to host_scan."""
    needs_card()
    for problem in gate_problems():
        mp = tgs.max_passes_for(problem.n)
        for wide in (None, True):
            arrays = tgs.scan_arrays(problem, wide=wide)
            cpu_status, cpu_passes = tgs._gate_scan(
                *[torch.from_numpy(a) for a in arrays], max_passes=mp)
            args = [torch.from_numpy(a).cuda() for a in arrays]
            torch.cuda.synchronize()
            (status, passes), syncs = count_syncs(
                lambda: tgs._gate_scan(*args, max_passes=mp))
            assert passes == cpu_passes
            assert torch.equal(status.cpu(), cpu_status)
            assert syncs <= passes + 1, (syncs, passes)
        d_adm, d_held, stats = tgs.device_admit(problem, device="cuda")
        v_adm, v_held, _ = host_scan(problem)
        assert [a.allocation_key for a in d_adm] == [a.allocation_key
                                                     for a in v_adm]
        assert d_held == v_held and stats["passes"] <= stats["max_passes"]


@pytest.mark.cuda
def test_card_encode_rows_equal_cpu_with_saturation():
    needs_card()
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 2**40, (64, 8), dtype=np.int64)
    raw[0, 0] = 2**31 - 128     # exact
    raw[1, 0] = 2**31 - 64      # rounds to 2^31 in float32: saturates
    raw[2, 0] = 3_000_000_000   # a bare cast wraps on the CPU
    raw[3, 3] = -(2**33)
    scales = np.array([1, 2**20, 1, 1, 1, 1000, 1, 3], np.float64)
    slots = np.arange(1, 65, dtype=np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        out[dev] = tgs.encode_rows(torch.zeros((128, 8), dtype=torch.int32,
                                               device=dev),
                                   t(raw), t(scales), t(slots)).cpu()
    assert torch.equal(out["cpu"], out["cuda"])
    assert out["cuda"][1, 0] == 2**31 - 128
    assert out["cuda"][2, 0] == out["cuda"][3, 0] == 2**31 - 1
    assert out["cuda"][4, 3] == -(2**31)


@pytest.mark.cuda
def test_card_row_store_gather_equals_batch_req():
    needs_card()
    _cache, enc, batch, asks = pressure_encoder()
    req = enc.device_req(asks, batch, device="cuda")
    assert req.device.type == "cuda"
    assert np.array_equal(req.cpu().numpy(), batch.req.astype(np.int32))
    assert enc.row_store.last_upload_rows == len(asks)
    enc.device_req(asks, batch, device="cuda")
    assert enc.row_store.last_upload_rows == 0


@pytest.mark.cuda
def test_card_clean_warm_solve_uploads_no_node_bytes():
    """A warm solve with nothing changed reads the mirror clean and uploads
    0 node bytes, and places as the host-array solve on the CPU."""
    needs_card()
    _cache, enc, batch, asks = pressure_encoder()
    batch.req_device = enc.device_req(asks, batch, device="cuda")
    first = solve_batch(batch, enc.nodes, device="cuda",
                        device_state=enc.device_arrays(device="cuda"))
    assert enc.device.take_upload_bytes() > 0
    warm = solve_batch(batch, enc.nodes, device="cuda",
                       device_state=enc.device_arrays(device="cuda"))
    assert enc.device.last_refresh == "clean"
    assert enc.device.take_upload_bytes() == 0
    batch.req_device = None
    host = solve_batch(batch, enc.nodes, device="cpu")
    for res in (first, warm):
        assert torch.equal(res.assigned.cpu(), host.assigned)
        assert torch.equal(res.free_after.cpu(), host.free_after)


@pytest.mark.cuda
def test_card_core_gates_on_the_device():
    """The port's core on the card with its defaults: the gate scans on the
    card, the solve reads the mirror (clean on the warm cycle), and it
    binds as the same core on the CPU."""
    needs_card()
    out = {}
    for device in ("cuda", None):
        e = Env(PORT, device, nodes=2, node_cpu=16000)
        e.add_app("app-1", "root.parent.childa")   # a 10-vcore quota
        e.submit([e.ask("app-1", f"p{i}", mem=2**20) for i in range(5)])
        e.core.schedule_once()
        e.submit([e.ask("app-1", f"q{i}", mem=2**20) for i in range(3)])
        e.core.schedule_once()
        last = e.core.metrics["last_cycle"]["default"]
        assert last["gate_path"] == "device"
        out[device] = e.record()
        if device == "cuda":
            assert last["node_refresh"] == "clean"
            assert last["node_upload_bytes"] == 0
    assert out["cuda"] == out[None]
