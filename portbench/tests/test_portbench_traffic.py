"""The generator and the window's arithmetic: the seed fixes the waves,
another seed draws another order of the same work, the fleet is the
configuration's, and the rate is every placed pod over every second."""
import json
import os

import bench_paths
from bench_paths import BENCH

from lib import faults, fleet, harness, trace, traffic

SEEDS = (7, 2**31 + 11)


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def cfg_mix(config, mix):
    return load("configs", config + ".json"), load("traffic", mix + ".json")


def test_waves_repeat_per_seed_and_differ_across_seeds():
    cfg, mix = cfg_mix("kwok-10k-pack", "burst")
    cfg = dict(cfg, backlog_pods=500)
    a = [traffic.wave_order(traffic.wave_plan(cfg, mix), SEEDS[0],
                            k) for k in range(3)]
    b = [traffic.wave_order(traffic.wave_plan(cfg, mix), SEEDS[0],
                            k) for k in range(3)]
    c = [traffic.wave_order(traffic.wave_plan(cfg, mix), SEEDS[1],
                            k) for k in range(3)]
    assert a == b
    assert a != c
    assert a[0] != a[1]
    # every wave holds the same pods, each once
    assert sorted(a[0]) == sorted(c[2])
    assert len(set(a[0])) == 500


def test_wave_plan_gives_each_deployment_its_own_queue():
    cfg, mix = cfg_mix("kwok-10k-pack", "burst")
    plan = traffic.wave_plan(cfg, mix)
    assert [d["queue"] for d in plan["deployments"]] == list(range(5))
    assert [d["shape"] for d in plan["deployments"]] == [0] * 5
    assert plan["pods_per_deployment"] * 5 == cfg["backlog_pods"]


def test_fleet_is_the_configurations():
    cfg, _ = cfg_mix("kwok-10k-pack", "burst")
    nodes = fleet.make_nodes(dict(cfg, nodes=20))
    assert len(nodes) == 20 and len({n.name for n in nodes}) == 20
    assert all(n.labels == cfg["node_labels"] and n.taints == ()
               and (n.cpu_milli, n.memory, n.pods) == (32000, 256 * 2**30,
                                                        110)
               for n in nodes)
    (sleep,) = fleet.shapes(cfg)
    assert (sleep.cpu_milli, sleep.memory, sleep.constraint) == (
        100, 50 * 2**20, None)
    # a configuration's keys turn on the zone and tier labels and the soft
    # taints
    more = fleet.make_nodes(dict(cfg, nodes=10, zones=4, gold_every=8,
                                 soft_taint_every=5))
    assert [n.labels["zone"] for n in more[:5]] == ["z0", "z1", "z2", "z3",
                                                    "z0"]
    assert [n.name for n in more if n.labels["tier"] == "gold"] == [
        "kwok-node-0", "kwok-node-8"]
    assert sum(1 for n in more if n.taints) == 2


def test_control_gives_the_program_one_slot_more():
    cfg, _ = cfg_mix("kwok-10k-pack", "burst")
    nodes = fleet.make_nodes(dict(cfg, nodes=3))
    handed = faults.overrides("control")["program_nodes"](nodes)
    assert [n.pods for n in handed] == [111] * 3
    assert [n.pods for n in nodes] == [110] * 3


def test_rate_is_every_placed_pod_over_every_second():
    reader = harness.metric_reader("pods_per_s.burst")
    run = harness.Run("c", {}, {}, 1, 20.0, False)
    run.t0, run.t1 = 10.0, 35.0
    run.notes["placed_in_window"] = 250000
    assert reader(run) == 10000.0
    run.notes["placed_in_window"] = 0
    assert reader(run) == 0.0
    run.t1 = run.t0
    assert reader(run) is None


def test_device_ms_is_the_union_of_the_window_per_kpod():
    reader = harness.metric_reader("device_ms_per_kpod")
    run = harness.Run("c", {}, {}, 1, 20.0, False)
    run.notes["placed_in_window"] = 100000
    assert reader(run) is None
    # two overlapping operations and one apart: 0.3 s + 0.1 s busy, one
    # clipped at the stretch's end
    run.window_profile = trace.Profile(
        [("a", 1.0, 1.2), ("b", 1.1, 1.3), ("c", 5.0, 5.4)], 0.0, 5.1)
    assert abs(reader(run) - 400.0 / 100) < 1e-9
    run.window_profile = trace.Profile([], 0.0, 5.1)
    assert reader(run) is None
