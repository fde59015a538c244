"""Batched predicate evaluation (the JAX package's ops/predicates.py in
PyTorch): node selector / required node affinity, taints and tolerations,
host ports and node state for all constraint groups × all nodes.

Bitsets are uint32 words carried as int32 views: `&`, `|`, `~`, `== 0` and
`!= 0` do not depend on the sign. Loops run over the words that hold any set
bit on the side that can fail the test (every other word passes trivially),
so the cost follows the constraints in use rather than the label vocabulary,
which grows with the node count (one hostname label per node). The boolean
results do not depend on the order of the words; the one float accumulation
(`group_preferred_bonus`) keeps the reference's order over terms and its
arithmetic as XLA compiles it.
"""
from __future__ import annotations

from typing import List

import torch


def _live_words(*bitsets: torch.Tensor) -> List[int]:
    """Indexes of the last-axis words that are non-zero in any row of any
    of the bitsets (one host read)."""
    W = bitsets[0].shape[-1]
    live = torch.zeros((W,), dtype=torch.bool, device=bitsets[0].device)
    for b in bitsets:
        live |= (b.reshape(-1, W) != 0).any(dim=0)
    return torch.nonzero(live).flatten().tolist()


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 word carried in an int32 tensor (SWAR count).

    Widened to int64 and masked first: torch's `>>` on int32 is arithmetic
    and would smear bit 31 into the count."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def group_screen(
    g_term_req,    # [G, T, W] int32 (uint32 bits)
    g_term_forb,   # [G, T, W]
    g_term_valid,  # [G, T] bool
    g_anyof,       # [G, T, E, W]
    g_anyof_valid, # [G, T, E] bool
    g_tol,         # [G, Wt]
    node_labels,   # [M, W]
    node_taints,   # [M, Wt] (hard effects only)
    node_ok,       # [M] bool (valid & schedulable)
) -> torch.Tensor:  # [G, M] bool
    """Selector/affinity + taints + schedulable — the port-free subset of
    group_feasibility (the preemption planner's candidate screen)."""
    G, T, _W = g_term_req.shape
    E = g_anyof.shape[2]
    M = node_labels.shape[0]
    dev = node_labels.device

    # --- selector / affinity terms ---
    term_ok = torch.ones((G, T, M), dtype=torch.bool, device=dev)
    for w in _live_words(g_term_req, g_term_forb):
        nl = node_labels[:, w][None, None, :]
        term_ok &= (g_term_req[:, :, w][:, :, None] & ~nl) == 0
        term_ok &= (g_term_forb[:, :, w][:, :, None] & nl) == 0
    anyof_words = _live_words(g_anyof)
    for e in range(E):
        hit = torch.zeros((G, T, M), dtype=torch.bool, device=dev)
        for w in anyof_words:
            hit |= (g_anyof[:, :, e, w][:, :, None]
                    & node_labels[:, w][None, None, :]) != 0
        term_ok &= (~g_anyof_valid[:, :, e][:, :, None]) | hit
    sel_ok = (term_ok & g_term_valid[:, :, None]).any(dim=1)        # [G, M]

    # --- taints vs tolerations ---
    taint_bad = torch.zeros((G, M), dtype=torch.bool, device=dev)
    for w in _live_words(node_taints):
        taint_bad |= (node_taints[:, w][None, :] & ~g_tol[:, w][:, None]) != 0

    return sel_ok & ~taint_bad & node_ok[None, :]


def group_feasibility(
    g_term_req, g_term_forb, g_term_valid, g_anyof, g_anyof_valid,
    g_tol,         # [G, Wt]
    g_ports,       # [G, Wp]
    node_labels, node_taints,
    node_ports,    # [M, Wp]
    node_ok,
) -> torch.Tensor:  # [G, M] bool
    base_ok = group_screen(g_term_req, g_term_forb, g_term_valid, g_anyof,
                           g_anyof_valid, g_tol, node_labels, node_taints,
                           node_ok)
    # --- host-port conflicts ---
    G = g_ports.shape[0]
    M = node_labels.shape[0]
    port_bad = torch.zeros((G, M), dtype=torch.bool, device=node_labels.device)
    for w in _live_words(g_ports):
        port_bad |= (g_ports[:, w][:, None] & node_ports[:, w][None, :]) != 0
    return base_ok & ~port_bad


def group_preferred_bonus(
    g_pref_req,    # [G, P, W] int32 (uint32 bits)
    g_pref_forb,   # [G, P, W]
    g_pref_weight, # [G, P] float32
    node_labels,   # [M, W]
) -> torch.Tensor:  # [G, M] float32
    """preferredDuringSchedulingIgnoredDuringExecution scoring: each satisfied
    weighted term adds weight/100 * 0.25 to the node's score for that group.
    Terms accumulate in order t = 0, 1, ... as in the reference."""
    G, P, _W = g_pref_req.shape
    M = node_labels.shape[0]
    dev = node_labels.device
    words = _live_words(g_pref_req, g_pref_forb)
    bonus = torch.zeros((G, M), dtype=torch.float32, device=dev)
    inv_100 = torch.full((), 0.01, dtype=torch.float32, device=dev)
    for t in range(P):
        ok = torch.ones((G, M), dtype=torch.bool, device=dev)
        for w in words:
            nl = node_labels[:, w][None, :]
            ok &= (g_pref_req[:, t, w][:, None] & ~nl) == 0
            ok &= (g_pref_forb[:, t, w][:, None] & nl) == 0
        # weight / 100 * 0.25 as XLA evaluates it: the divide folded into a
        # multiply by float32(0.01)
        add = g_pref_weight[:, t][:, None] * inv_100 * 0.25
        bonus = bonus + torch.where(ok, add, torch.zeros_like(add))
    return bonus


def group_soft_penalty(
    g_tol,             # [G, Wt] int32 (uint32 bits)
    node_taints_soft,  # [M, Wt] (PreferNoSchedule taints)
) -> torch.Tensor:     # [G, M] float32
    """Soft-taint penalty: -0.25 per untolerated PreferNoSchedule taint bit."""
    G = g_tol.shape[0]
    M = node_taints_soft.shape[0]
    count = torch.zeros((G, M), dtype=torch.int32, device=g_tol.device)
    for w in _live_words(node_taints_soft):
        bad = node_taints_soft[:, w][None, :] & ~g_tol[:, w][:, None]
        count += popcount32(bad)
    return -0.25 * count.to(torch.float32)
