"""The plain reference against hand-made tiny fleets, and its greedy
replay against the program's greedy solve on the CPU."""
import json
import os

import pytest
import torch

import bench_paths
from bench_paths import BENCH

from lib import fleet
from reference import check, greedy

GI = 2**30
# the kwok configuration with the constraints the reference also models
# (zones, gold tiers, soft taints; a selector and a preferred term)
CONSTRAINED = {
    "zones": 4, "gold_every": 8, "soft_taint_every": 5,
    "shapes": [
        {"name": "sleep", "cpu_milli": 100, "memory_bytes": 50 * 2**20,
         "constraint": None},
        {"name": "zone-z1", "cpu_milli": 2000, "memory_bytes": 8 * GI,
         "constraint": "selector"},
        {"name": "prefer-gold", "cpu_milli": 4000, "memory_bytes": 16 * GI,
         "constraint": "preferred"},
        {"name": "small", "cpu_milli": 500, "memory_bytes": 2 * GI,
         "constraint": None},
        {"name": "large", "cpu_milli": 8000, "memory_bytes": 32 * GI,
         "constraint": None}]}


def kwok_cfg(**changes):
    with open(os.path.join(BENCH, "configs", "kwok-10k-pack.json")) as f:
        cfg = json.load(f)
    cfg.update(changes)
    return cfg


def node(name, cpu=4000, mem=8 * GI, pods=3, labels=None, taints=()):
    return fleet.NodeSpec(name, cpu, mem, pods, dict(labels or {}),
                          tuple(taints))


def ledger(nodes, pods):
    lg = check.Ledger(nodes, pods)
    for k in pods:
        lg.apply(("ask", k))
    return lg


def test_overcommit_and_release():
    pods = {"a": (3000, GI, {}), "b": (2000, GI, {}), "c": (1000, GI, {})}
    lg = ledger([node("n0")], pods)
    lg.apply(("alloc", "a", "n0"))
    lg.apply(("alloc", "b", "n0"))          # 5000 > 4000 milli
    assert lg.counts["overcommit"] == 1
    lg.apply(("release", "b"))
    lg.apply(("release", "a"))
    lg.apply(("alloc", "c", "n0"))          # the capacity came back
    assert lg.counts["overcommit"] == 1
    assert lg.live == {"c": "n0"}


@pytest.mark.parametrize("allowed", [(), ("PREEMPTED_BY_SCHEDULER",)])
def test_program_release_frees_and_is_held_to_the_allowed_types(allowed):
    pods = {"a": (3000, GI, {}), "b": (3000, GI, {})}
    lg = check.Ledger([node("n0")], pods, allowed)
    for k in pods:
        lg.apply(("ask", k))
    lg.apply(("alloc", "a", "n0"))
    lg.apply(("program_release", "a", "PREEMPTED_BY_SCHEDULER"))
    lg.apply(("alloc", "b", "n0"))          # the victim's capacity came back
    assert lg.counts["overcommit"] == 0
    assert lg.counts["program_release"] == (0 if allowed else 1)
    assert lg.live == {"b": "n0"}
    lg.apply(("program_release", "a", "PREEMPTED_BY_SCHEDULER"))  # not live
    lg.apply(("release", "a"))              # the harness's release after it
    assert lg.counts["unknown_or_double"] == 1
    assert lg.live == {"b": "n0"}


def test_pod_slots_count():
    pods = {k: (10, 1, {}) for k in "abcd"}
    lg = ledger([node("n0", pods=3)], pods)
    for k in "abcd":
        lg.apply(("alloc", k, "n0"))
    assert lg.counts["overcommit"] == 1


def test_selector_and_hard_taint():
    pods = {"s": (100, GI, {"zone": "z1"}), "t": (100, GI, {})}
    nodes = [node("n0", labels={"zone": "z0"}),
             node("n1", labels={"zone": "z1"},
                  taints=[("gpu", "1", "NoSchedule")]),
             node("n2", labels={"zone": "z1"},
                  taints=[("noisy", "1", "PreferNoSchedule")])]
    lg = ledger(nodes, pods)
    lg.apply(("alloc", "s", "n0"))
    lg.apply(("alloc", "t", "n1"))
    assert lg.counts["selector_taint"] == 2
    lg2 = ledger(nodes, pods)
    lg2.apply(("alloc", "s", "n2"))          # PreferNoSchedule is soft
    assert lg2.counts["selector_taint"] == 0


def test_double_and_unknown_allocations():
    pods = {"a": (100, GI, {})}
    lg = ledger([node("n0")], pods)
    lg.apply(("alloc", "a", "n0"))
    lg.apply(("alloc", "a", "n0"))           # twice while live
    lg.apply(("release", "a"))
    lg.apply(("alloc", "a", "n0"))           # no longer asked for
    assert lg.counts["unknown_or_double"] == 2


def test_state_gap_and_fits_anywhere():
    pods = {"a": (3000, GI, {}), "b": (3000, GI, {})}
    lg = ledger([node("n0"), node("n1")], pods)
    lg.apply(("alloc", "a", "n0"))
    assert lg.fits_anywhere("b")
    assert check.state_gap(lg, {"a": "n0"}, {"a": "n0"}) == 0
    assert check.state_gap(lg, {"a": "n1"}, {}) == 2
    lg.apply(("alloc", "b", "n1"))
    assert check.state_gap(lg, {"a": "n0"}, {"a": "n0", "b": "n1"}) == 1


def tiny_replay(reqs, groups, feas, soft, caps):
    cap = torch.tensor(caps, dtype=torch.int64)
    return greedy.replay(torch.tensor(reqs, dtype=torch.int64),
                         torch.tensor(groups), torch.tensor(feas),
                         torch.tensor(soft, dtype=torch.float32),
                         cap.clone(), cap)


def test_replay_packs_the_fullest_node_first():
    caps = [greedy.cap_row(4000, 8 * GI, 10, 64)] * 2
    reqs = [greedy.req_row(1000, GI)] * 6
    out = tiny_replay(reqs, [0] * 6, [[True, True]], [[0.0, 0.0]], caps)
    # bin packing: node 0 until full (4 pods of 1 cpu), then node 1
    assert out.assigned == [0, 0, 0, 0, 1, 1]


def test_replay_honours_feasibility_and_soft_terms():
    caps = [greedy.cap_row(4000, 8 * GI, 10, 64)] * 3
    reqs = [greedy.req_row(1000, GI)] * 2
    out = tiny_replay(reqs, [0, 1], [[True, True, True], [False, False, True]],
                      [[-0.25, 0.0, 0.0], [0.0, 0.0, 0.0]], caps)
    assert out.assigned == [1, 2]


def test_replay_leaves_what_fits_nowhere():
    caps = [greedy.cap_row(2000, 8 * GI, 10, 64)]
    reqs = [greedy.req_row(1500, GI)] * 2
    out = tiny_replay(reqs, [0, 0], [[True]], [[0.0]], caps)
    assert sorted(out.assigned) == [-1, 0]


def test_duel_key_orders_placed_then_units():
    reqs = [[1, 1], [2, 2], [1, 1]]
    cap_mean = [4.0, 4.0]
    a = [0, 0, -1]
    b = [0, 1, 1]
    sc = max(greedy.units(a, reqs, cap_mean), greedy.units(b, reqs, cap_mean))
    assert greedy.duel_key(b, reqs, cap_mean, sc) > \
        greedy.duel_key(a, reqs, cap_mean, sc)


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("n_nodes,n_pods", [(40, 500), (200, 2000),
                                            (30, 5000)])
def test_replay_equals_the_programs_greedy_cycle(n_nodes, n_pods,
                                                 constrained):
    """The program's greedy solve on the CPU, through its core, against
    the replay (the test alone imports both); the last size leaves pods
    that fit nowhere."""
    from lib import traffic
    from lib.program import Program

    cfg = kwok_cfg(nodes=n_nodes, backlog_pods=n_pods,
                   solver={"policy": "greedy"},
                   **(CONSTRAINED if constrained else {}))
    mix = {"deployments": 5}
    seed = 2**31 + 5
    nodes = fleet.make_nodes(cfg)
    shapes = fleet.shapes(cfg)
    plan = traffic.wave_plan(cfg, mix)
    deps = plan["deployments"]
    prog = Program(cfg, nodes, "cpu")
    apps = [(f"dep-{d}", f"root.q{dep['queue']}")
            for d, dep in enumerate(deps)]
    prog.add_apps(apps)
    order = traffic.wave_order(plan, seed, 0)
    asks = []
    for d, i in order:
        pod = prog.make_pod(f"p-{d}-{i}", apps[d][0], apps[d][1],
                            shapes[deps[d]["shape"]])
        asks.append(prog.make_ask(f"a-{d}-{i}", apps[d][0], pod))
    prog.submit(asks)
    prog.core.schedule_once()
    got = {ev[1]: ev[2] for ev in prog.recorder.log if ev[0] == "alloc"}
    snodes = sorted(nodes, key=lambda n: n.name)
    g_of, feas, soft = greedy.group_tables(snodes, shapes, "cpu")
    cap = torch.tensor([greedy.cap_row(n.cpu_milli, n.memory, n.pods,
                                       cfg["node_volume_limit"])
                        for n in snodes])
    ranked = sorted(range(len(order)),
                    key=lambda j: (apps[order[j][0]][1], j))
    req = torch.tensor([greedy.req_row(shapes[deps[order[j][0]]["shape"]]
                                       .cpu_milli,
                                       shapes[deps[order[j][0]]["shape"]]
                                       .memory) for j in ranked])
    grp = torch.tensor([g_of[deps[order[j][0]]["shape"]] for j in ranked])
    ref = greedy.replay(req, grp, feas, soft, cap.clone(), cap)
    want = {asks[j].allocation_key: snodes[r].name
            for j, r in zip(ranked, ref.assigned) if r >= 0}
    assert got == want


@pytest.mark.cuda
def test_replay_on_the_card_equals_the_cpu():
    """The replay's float32 scores and integer scans give the same plan on
    the card as on the CPU (the benchmark runs it on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = kwok_cfg(nodes=500, **CONSTRAINED)
    nodes = sorted(fleet.make_nodes(cfg), key=lambda n: n.name)
    shapes = fleet.shapes(cfg)
    plans = []
    for dev in ("cpu", "cuda"):
        g_of, feas, soft = greedy.group_tables(nodes, shapes, dev)
        cap = torch.tensor([greedy.cap_row(n.cpu_milli, n.memory, n.pods, 64)
                            for n in nodes], device=dev)
        pods = [k % 5 for k in range(5000)]
        req = torch.tensor([greedy.req_row(shapes[s].cpu_milli,
                                           shapes[s].memory) for s in pods],
                           device=dev)
        grp = torch.tensor([g_of[s] for s in pods], device=dev)
        plans.append(greedy.replay(req, grp, feas, soft, cap.clone(), cap))
    assert plans[0] == plans[1]
