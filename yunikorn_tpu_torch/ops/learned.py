"""The learned policy inside the assignment solve (solver.policy=learned):
the port's counterpart of the JAX package's `_learned_prep` and of the
proposal half of `_learned_chunk_pass` (ops/assign.py there).

Once per pod slice, `learned_prep` embeds the asks with the pod tower and
makes the slice's exploration key. Every round, `node_embedding` embeds
the nodes' current free capacity with the node tower, and `learned_propose`
gives each active pod the node its two-tower score picks under seeded
Gumbel exploration, gated by a confidence margin: for pod i over its
feasible and fitting nodes m (group row and min_r(free - req) >= 0),

    ls     = pod_emb[i] . node_emb[m]          (ops/best_nodes.learned_dot)
    u      = ls + tau * g,  g the Gumbel value a draw of shape (chunk,
             M) under the key fold_in(fold_in(key, rnd), c) holds at row
             i - c * chunk, column m, for c = i // chunk (utils/prng: the
             reference's random stream)
    pick   = the first argmax of u
    nf     = the number of such nodes, lmean = sum(ls) / max(nf, 1)
             (summed and divided in float64, rounded once to float32, so
             the kernel's order and the plain version's give one lmean)
    prop   = pick if nf > 0 and ls[pick] - lmean > GATE_MARGIN else M

An untrained checkpoint embeds every pod to zero, so ls is 0, the gate never
fires and the learned solve is the greedy one bit for bit.

On CUDA tensors `learned_propose` launches the hand-written kernel in
`csrc/learned_propose.cu` (threefry2x32 in registers, the [N, M] noise never
stored); on CPU tensors it takes `learned_propose_reference`, the plain
PyTorch version. There is no fallback between the two. The random words are
exact on both; the two logarithms of the Gumbel transform are the
device's, so the noise, and with it a pick on a near-tie, may differ in
the last bit from another library's.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from yunikorn_tpu_torch.ops.best_nodes import (NEG_INF, _check, learned_dot,
                                               pad_emb, padded_emb)
from yunikorn_tpu_torch.policy import features as pf
from yunikorn_tpu_torch.policy import net as pnet
from yunikorn_tpu_torch.utils import prng, torchtools

# the kernel's library: csrc/<LIBRARY>.cu, built by utils/torchtools
LIBRARY = "learned_propose"


class LearnedRT(NamedTuple):
    """One pod slice's learned-scorer state (learned_prep)."""
    params: dict               # device-form params (policy/net)
    pod_emb: torch.Tensor      # [N, E] float32
    key: torch.Tensor          # [2] int64: the slice's exploration key
    inv_scale: torch.Tensor    # [R_score] float32


def learned_prep(learned, req, capacity, score_cols: int = 0,
                 salt=None) -> LearnedRT:
    """The hoisted pod side of the learned scorer for one pod slice.

    learned = (params, seed): params in host form (numpy leaves) or device
    form (policy/net.params_from_numpy), seed an int. req [N, R] and
    capacity [M, R] are the solve's integer tensors; score_cols > 0 keeps
    the features to the first score_cols columns. salt, when given, is
    folded into the key (the chained solve's slice index, so two slices
    never share noise)."""
    params, seed = learned
    params = pnet.params_from_numpy(params, req.device)
    sc = score_cols if score_cols > 0 else req.shape[1]
    inv_sc = pf.inv_capacity_scale(capacity[:, :sc])
    pod_emb = pnet.pod_tower(params, pf.pod_features(req[:, :sc], inv_sc))
    key = prng.prng_key(int(seed), req.device)
    if salt is not None:
        key = prng.fold_in(key, int(salt))
    return LearnedRT(params, pod_emb.contiguous(), key, inv_sc)


def node_embedding(rt: LearnedRT, free, capacity,
                   score_cols: int = 0) -> torch.Tensor:
    """[M, E] float32: the node tower over the current free capacity."""
    sc = score_cols if score_cols > 0 else free.shape[1]
    feats = pf.node_features(free[:, :sc], capacity[:, :sc], rt.inv_scale)
    return pnet.node_tower(rt.params, feats).contiguous()


def chunk_scores(pod_emb, node_emb, group_id, group_feas, free, req,
                 tau: float, round_key, c: int, chunk: int):
    """The plain scores of noise block c (rows c * chunk onwards): (ok
    [C, M] bool, ls [C, M] float32, u [C, M] float32, NEG_INF where not
    ok), round_key = fold_in(key, rnd)."""
    sl = slice(c * chunk, (c + 1) * chunk)
    creq = req[sl]
    ok = group_feas[group_id[sl].long()]                             # [C, M]
    for r in range(req.shape[1]):
        ok = ok & (free[:, r][None, :] >= creq[:, r][:, None])
    ls = learned_dot(pod_emb[sl], node_emb)                          # [C, M]
    g = prng.gumbel(prng.fold_in(round_key, c), tuple(ls.shape))
    u = torch.where(ok, ls + tau * g, torch.full_like(ls, NEG_INF))
    return ok, ls, u


def learned_propose_reference(pod_emb, node_emb, group_id, group_feas, free,
                              req, active, tau: float, key, rnd: int,
                              chunk: int):
    """Plain PyTorch version of the gated proposal pass, one [chunk, M]
    block at a time. Returns (prop [N] int32, M where no override; pick [N]
    int32; nf [N] int32; lmean [N] float32); inactive rows give prop M,
    pick 0, nf 0, lmean 0."""
    N = req.shape[0]
    M = free.shape[0]
    dev = req.device
    round_key = prng.fold_in(key, int(rnd))
    parts = ([], [], [], [])
    for c in range(-(-N // chunk)):
        ok, ls, u = chunk_scores(pod_emb, node_emb, group_id, group_feas,
                                 free, req, tau, round_key, c, chunk)
        nf = ok.sum(dim=1, dtype=torch.int32)
        lmean = (torch.where(ok, ls, 0.0).sum(dim=1, dtype=torch.float64)
                 / nf.double().clamp(min=1.0)).float()
        if M:
            pick = torch.argmax(u, dim=1)
            ls_best = ls.gather(1, pick[:, None])[:, 0]
        else:
            pick = torch.zeros((u.shape[0],), dtype=torch.int64, device=dev)
            ls_best = lmean
        good = (nf > 0) & (ls_best - lmean > pnet.GATE_MARGIN)
        for out, v in zip(parts, (torch.where(good, pick, M), pick, nf,
                                  lmean)):
            out.append(v)
    if not parts[0]:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return z, z, z, torch.zeros((0,), dtype=torch.float32, device=dev)
    prop, pick, nf, lmean = (torch.cat(p) for p in parts)
    return (torch.where(active, prop, M).to(torch.int32),
            torch.where(active, pick, 0).to(torch.int32),
            torch.where(active, nf, 0).to(torch.int32),
            torch.where(active, lmean, 0.0))


def _library():
    lib = torchtools.load_library(LIBRARY)
    if not getattr(lib, "_yk_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.yk_learned_propose.argtypes = (
            [p] * 8 + [i, i, ctypes.c_float, i, i, i, i, i] + [p] * 12)
        lib.yk_learned_propose.restype = i
        lib.yk_learned_propose_max_res.restype = i
        lib.yk_learned_propose_slice_nodes.restype = i
        lib.yk_cuda_error_string.argtypes = [i]
        lib.yk_cuda_error_string.restype = ctypes.c_char_p
        lib._yk_typed = True
    return lib


def slice_nodes() -> int:
    """Nodes per block slice of the kernel (the node range splits across
    blocks at multiples of this)."""
    return _library().yk_learned_propose_slice_nodes()


def learned_propose(pod_emb, node_emb, group_id, group_feas, free, req,
                    active, tau: float, key, rnd: int, chunk: int):
    """The gated learned proposal of every active pod. Shapes: pod_emb
    [N, E] and node_emb [M, E] float32 (E at most 32), group_id [N] int32,
    group_feas [G, M] bool, free [M, R] int32, req [N, R] int32, active [N]
    bool, key [2] int64 (utils/prng), rnd the round, chunk the rows of one
    noise block (N a multiple of it).

    Returns (prop, pick, nf, lmean) as learned_propose_reference does. CPU
    tensors take the plain version; CUDA tensors launch the kernel (and add
    one to `learned_propose.launches`)."""
    device = req.device
    if device.type == "cpu":
        return learned_propose_reference(pod_emb, node_emb, group_id,
                                         group_feas, free, req, active, tau,
                                         key, rnd, chunk)
    if device.type != "cuda":
        raise ValueError(f"learned_propose runs on cuda or cpu tensors, not "
                         f"{device.type}")
    N, R = req.shape
    G, M = group_feas.shape
    E = pod_emb.shape[1] if pod_emb.dim() == 2 else -1
    _check("pod_emb", pod_emb, torch.float32, (N, E), device)
    _check("node_emb", node_emb, torch.float32, (M, E), device)
    _check("group_id", group_id, torch.int32, (N,), device)
    _check("group_feas", group_feas, torch.bool, (G, M), device)
    _check("free", free, torch.int32, (M, R), device)
    _check("req", req, torch.int32, (N, R), device)
    _check("active", active, torch.bool, (N,), device)
    _check("key", key, torch.int64, (2,), device)
    if G < 1:
        raise ValueError("group_feas needs at least one group row")
    if chunk < 1 or N % chunk:
        raise ValueError(f"{N} rows must be a multiple of the chunk {chunk}")
    lib = _library()
    if R > lib.yk_learned_propose_max_res():
        raise ValueError(f"learned_propose takes at most "
                         f"{lib.yk_learned_propose_max_res()} resource "
                         f"columns, got {R}")
    emb = padded_emb(E)
    pod_emb, node_emb = pad_emb(pod_emb, emb), pad_emb(node_emb, emb)
    i32 = dict(dtype=torch.int32, device=device)
    prop = torch.empty((N,), **i32)
    pick = torch.empty((N,), **i32)
    nf = torch.empty((N,), **i32)
    lmean = torch.empty((N,), dtype=torch.float32, device=device)
    if N == 0:
        return prop, pick, nf, lmean
    n_words = (M + 31) // 32
    n_slices = -(-M // lib.yk_learned_propose_slice_nodes())
    words = torch.empty((G, n_words), **i32)
    chunk_keys = torch.empty((N // chunk, 2), **i32)
    row_key = torch.empty((N,), dtype=torch.int64, device=device)
    row_nf = torch.empty((N,), **i32)
    row_list = torch.empty((N,), **i32)
    row_count = torch.empty((1,), **i32)
    partial = torch.empty((N, n_slices), dtype=torch.float64, device=device)
    rc = lib.yk_learned_propose(
        req.data_ptr(), group_id.data_ptr(), group_feas.data_ptr(),
        free.data_ptr(), active.data_ptr(), pod_emb.data_ptr(),
        node_emb.data_ptr(), key.data_ptr(), int(rnd), int(chunk),
        float(tau), N, M, G, R, emb, words.data_ptr(), chunk_keys.data_ptr(),
        row_key.data_ptr(), row_nf.data_ptr(), row_list.data_ptr(),
        row_count.data_ptr(), partial.data_ptr(), prop.data_ptr(),
        pick.data_ptr(), nf.data_ptr(), lmean.data_ptr(),
        torchtools.current_stream_handle(device))
    if rc != 0:
        raise RuntimeError("learned_propose kernel launch failed: "
                           + lib.yk_cuda_error_string(rc).decode())
    learned_propose.launches += 1
    return prop, pick, nf, lmean


learned_propose.launches = 0
