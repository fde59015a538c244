"""Plain PyTorch replay of the greedy batched solve, from the benchmark's
own fleet and pods: the placement a greedy cycle must make.

The semantics, written out independently of the program (nothing here
imports it): pods are taken in rank order; nodes are scored by the
bin-packing base score (1 - the mean over the R device columns of
free / capacity, float32, summed left to right) plus each group's soft
term (+0.25 for a satisfied preferred term of weight 100, -0.25 for each
PreferNoSchedule taint the group does not tolerate). Up to `max_rounds`
rounds run while fewer than two rounds in a row accept nothing:

1. water fill: per group, its feasible nodes in score order (ties by node
   name, in string order), the prefix sums of their free capacity and of the group's
   active pods' requests in rank order, each saturating at CAP; a pod
   proposes the first node whose prefix covers its own, on every column;
2. a proposal fits if the node's free capacity covers the request;
3. in odd rounds each active pod whose proposal does not fit takes its
   exact best node instead: the highest score among its group's nodes that
   fit it, the first such node in name order on ties;
4. accept: candidates sorted by (node, rank); each node takes the prefix of
   its candidates whose running sum fits its free capacity; accepted
   requests leave the node's free capacity.

Units are the device's: cpu in millicores, memory in MiB (requests rounded
up, capacities down), pod slots, ephemeral storage (none here), attachable
CSI volumes (Kubernetes' default limit of 64 a node; the pods attach
none); the columns after them are zero up to R = 8.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import torch

CAP = 2**30 - 1
R = 8
NEG = -3.0e38
MIB = 2**20


class Replay(NamedTuple):
    assigned: List[int]          # node row per pod (rank order), -1 if none
    rounds: int
    odd_calls: List[dict]        # per best-node round: rows, admitted, fitting


def req_row(cpu_milli: int, memory: int) -> List[int]:
    return [cpu_milli, math.ceil(memory / MIB), 1] + [0] * (R - 3)


def cap_row(cpu_milli: int, memory: int, pods: int, volumes: int
            ) -> List[int]:
    return [cpu_milli, memory // MIB, pods, 0, volumes] + [0] * (R - 5)


def base_scores(free: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    ratio = free.float() / cap.float().clamp(min=1.0)
    total = ratio[:, 0]
    for r in range(1, ratio.shape[1]):
        total = total + ratio[:, r]
    # 1/8 is a power of two, so the product is exact and 1 - x rounds once,
    # as one fused multiply-add does
    return 1.0 - total * torch.tensor(1.0 / ratio.shape[1],
                                      dtype=torch.float32,
                                      device=free.device)


def replay(req: torch.Tensor, group: torch.Tensor, feas: torch.Tensor,
           soft: torch.Tensor, free0: torch.Tensor, cap: torch.Tensor,
           max_rounds: int = 16, chunk: int = 2048) -> Replay:
    """req [N, R] int64 in rank order, group [N] int64, feas [G, M] bool,
    soft [G, M] float32, free0 / cap [M, R] int64."""
    dev = req.device
    N, M, G = req.shape[0], free0.shape[0], feas.shape[0]
    free = free0.clone()
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    assigned = torch.full((N,), -1, dtype=torch.int64, device=dev)
    odd_calls = []
    rnd = stalls = 0
    idx = torch.arange(N, device=dev)
    while stalls < 2 and rnd < max_rounds and not bool(done.all()):
        base = base_scores(free, cap)
        active = ~done
        prop = torch.full((N,), M, dtype=torch.int64, device=dev)
        for g in range(G):
            mine = (active & (group == g)).nonzero().squeeze(1)
            if mine.numel() == 0:
                continue
            score = torch.where(feas[g], base + soft[g],
                                torch.full_like(base, NEG))
            order = torch.argsort(-score, stable=True)
            ofree = torch.where(feas[g][order][:, None],
                                free[order].clamp(min=0), 0).clamp(max=CAP)
            cum_free = torch.cumsum(ofree, 0).clamp(max=CAP)        # [M, R]
            cum_dem = torch.cumsum(req[mine].clamp(max=CAP), 0).clamp(max=CAP)
            pos = torch.zeros(mine.shape[0], dtype=torch.int64, device=dev)
            for r in range(R):
                pos = torch.maximum(pos, torch.searchsorted(
                    cum_free[:, r].contiguous(), cum_dem[:, r].contiguous(),
                    right=False))
            node = order[pos.clamp(max=M - 1)]
            prop[mine] = torch.where(pos < M, node, M)
        real = prop < M
        pc = prop.clamp(max=M - 1)
        fits = real & ((free[pc] - req) >= 0).all(dim=1)
        if rnd % 2 == 1:
            rows = (active & ~fits).nonzero().squeeze(1)
            best = torch.zeros(N, dtype=torch.int64, device=dev)
            feasible = torch.zeros(N, dtype=torch.bool, device=dev)
            admitted = fitting = 0
            for s in range(0, rows.shape[0], chunk):
                i = rows[s:s + chunk]
                ok = feas[group[i]]
                admitted += int(ok.sum())
                for r in range(R):
                    ok = ok & (free[:, r][None, :] >= req[i, r][:, None])
                fitting += int(ok.sum())
                sc = base[None, :] + soft[group[i]]
                masked = torch.where(ok, sc, torch.full_like(sc, NEG))
                best[i] = torch.argmax(masked, dim=1)
                feasible[i] = ok.any(dim=1)
            odd_calls.append({"rows": int(rows.shape[0]),
                              "admitted": admitted, "fitting": fitting})
            merged = torch.where(fits, prop, best)
            cand = active & (feasible | fits)
        else:
            merged, cand = prop, active & fits
        key = torch.where(cand, merged, M)
        order = torch.argsort(key, stable=True)       # by node, then rank
        snode = key[order]
        sreq = req[order]
        seg_start = torch.ones(N, dtype=torch.bool, device=dev)
        seg_start[1:] = snode[1:] != snode[:-1]
        head = torch.cummax(torch.where(seg_start, idx, 0), 0).values
        cums = torch.cumsum(sreq, 0)
        base_c = torch.where((head > 0)[:, None], cums[(head - 1).clamp(min=0)],
                             0)
        prefix = cums - base_c
        sreal = snode < M
        node_free = torch.where(sreal[:, None], free[snode.clamp(max=M - 1)], 0)
        acc_sorted = sreal & (prefix <= node_free).all(dim=1)
        accepted = torch.zeros(N, dtype=torch.bool, device=dev)
        accepted[order] = acc_sorted
        delta = torch.where(acc_sorted[:, None], sreq, 0)
        free = free.index_add(0, snode.clamp(max=M - 1),
                              torch.where(sreal[:, None], -delta, 0))
        assigned = torch.where(accepted, merged, assigned)
        done = done | accepted
        stalls = 0 if bool(acc_sorted.any()) else stalls + 1
        rnd += 1
    return Replay(assigned.tolist(), rnd, odd_calls)


def group_tables(nodes, shapes, device):
    """Per distinct constraint of the shapes: its feasible nodes and soft
    term. Returns (group index per shape, feas [G, M], soft [G, M])."""
    keys = []
    g_of = []
    for s in shapes:
        k = s.constraint if s.constraint in ("selector", "preferred") else None
        if k not in keys:
            keys.append(k)
        g_of.append(keys.index(k))
    M = len(nodes)
    feas = torch.ones((len(keys), M), dtype=torch.bool)
    soft = torch.zeros((len(keys), M), dtype=torch.float32)
    for m, n in enumerate(nodes):
        soft_taints = sum(1 for t in n.taints if t[2] == "PreferNoSchedule")
        hard = any(t[2] in ("NoSchedule", "NoExecute") for t in n.taints)
        for g, k in enumerate(keys):
            ok = not hard
            if k == "selector":
                ok = ok and n.labels.get("zone") == "z1"
            feas[g, m] = ok
            bonus = 0.25 if (k == "preferred"
                             and n.labels.get("tier") == "gold") else 0.0
            soft[g, m] = torch.tensor(-0.25 * soft_taints,
                                      dtype=torch.float32) + bonus
    return g_of, feas.to(device), soft.to(device)


def duel_key(assigned: List[int], reqs: List[List[int]], cap_mean: List[float],
             scale: float) -> tuple:
    """The duel's order of two plans (one priority class): placed asks,
    then capacity-normalised packed units (quantised against `scale`,
    the larger plan's), then fewer nodes touched."""
    placed = [i for i, a in enumerate(assigned) if a >= 0]
    return (len(placed), round(units(assigned, reqs, cap_mean) / scale * 1e9),
            -len({assigned[i] for i in placed}))


def units(assigned, reqs, cap_mean) -> float:
    inv = [1.0 / max(c, 1.0) for c in cap_mean]
    tot = 0.0
    for i, a in enumerate(assigned):
        if a >= 0:
            tot += sum(q * w for q, w in zip(reqs[i], inv))
    return tot
