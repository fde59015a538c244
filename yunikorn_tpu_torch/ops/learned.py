"""The learned policy inside the assignment solve (solver.policy=learned):
the port's counterpart of the JAX package's `_learned_prep` and of the
proposal half of `_learned_chunk_pass` (ops/assign.py there).

Once per pod slice, `learned_prep` embeds the asks with the pod tower and
makes the slice's exploration key. Every round, `node_embedding` embeds
the nodes' current free capacity with the node tower, and the proposal
pass gives each active pod the node its two-tower score picks under seeded
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

The pass runs in two parts (csrc/learned_propose.cu says how), so a node
mesh runs the first on each shard's device: `learned_propose_shard` over
the nodes node_offset .. node_offset + W of M gives each row's ordered key
(ops/best_nodes.exact_key's layout), its nf and its float64 sums of ls
over each SLICE_NODES-node slice, with the global node index in the noise
counters and the key; `merge_proposals` max-merges the keys, adds nf and
lays the slice tables side by side in shard order on the lead device; and
`learned_propose_finish` adds the slices in order, recomputes ls at the
pick from the [M, E] node embedding and applies the gate.
`learned_propose` is the shard part over all nodes and the finish.

An untrained checkpoint embeds every pod to zero, so ls is 0, the gate never
fires and the learned solve is the greedy one bit for bit.

On CUDA tensors both parts launch the hand-written kernel in
`csrc/learned_propose.cu` (threefry2x32 in registers, the [N, M] noise never
stored); on CPU tensors they take their plain PyTorch versions
(`learned_propose_shard_reference`, `learned_propose_finish_reference`).
There is no fallback between the two. The random words are exact on both;
the two logarithms of the Gumbel transform are the device's, so the noise,
and with it a pick on a near-tie, may differ in the last bit from another
library's. The slice sums add the nodes in order on both, so a kernel's
slice table and lmean equal its plain version's bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from yunikorn_tpu_torch.ops.best_nodes import (KEY_NONE, NEG_INF, _check,
                                               exact_key, learned_dot,
                                               pad_emb, padded_emb)
from yunikorn_tpu_torch.policy import features as pf
from yunikorn_tpu_torch.policy import net as pnet
from yunikorn_tpu_torch.utils import prng, torchtools

# the kernel's library: csrc/<LIBRARY>.cu, built by utils/torchtools
LIBRARY = "learned_propose"
# nodes per slice of the shard part's partial-sum table (the kernel's
# block width, checked against the library before each launch)
SLICE_NODES = 128
# rows of one node-tower product by device type: a fleet of M nodes is
# embedded in blocks of min(this, M) fleet rows, each block's rows at their
# places (a shard pads its rows into the block that holds them), so that a
# node's embedding comes from the same product at the same row whatever the
# shard layout. The card's product rounds by its row count (chip_smoke's
# mesh phase, `orders`: [16,384, F] against four [4,096, F] pieces), and so
# does the CPU's at one-row pieces. 4,096 on a card (one shard of a 4-shard
# mesh of the 16,384-node bucket embeds one block); 256 on the CPU, where a
# padded block costs its rows.
EMB_BLOCK = {"cuda": 4096, "cpu": 256}


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


def embed_nodes(params, feats, node_offset: int = 0,
                m_total=None) -> torch.Tensor:
    """[W, E] float32: the node tower (device-form params, moved to feats'
    device) over feats [W, F_NODE], the rows node_offset .. node_offset + W
    of a fleet of m_total nodes (default: W, the whole fleet), one product
    a block of min(EMB_BLOCK, m_total) fleet rows (by the device's type): a
    block this piece fills only in part is padded with zero rows around
    it."""
    params = pnet.params_from_numpy(params, feats.device)
    W = feats.shape[0]
    if W == 0:
        return pnet.node_tower(params, feats).contiguous()
    m_total = node_offset + W if m_total is None else int(m_total)
    B = min(EMB_BLOCK.get(feats.device.type, EMB_BLOCK["cpu"]), m_total)
    start = node_offset % B
    n_blocks = -(-(start + W) // B)
    x = feats
    if start or W != n_blocks * B:
        x = feats.new_zeros((n_blocks * B, feats.shape[1]))
        x[start:start + W] = feats
    out = torch.cat([pnet.node_tower(params, x[b * B:(b + 1) * B])
                     for b in range(n_blocks)])
    return out[start:start + W].contiguous()


def node_embedding(rt: LearnedRT, free, capacity, score_cols: int = 0,
                   node_offset: int = 0, m_total=None) -> torch.Tensor:
    """[W, E] float32: the node tower over the current free capacity of
    the rows node_offset .. node_offset + W of a fleet of m_total nodes
    (free, capacity [W, R], on the shard's device; default the whole
    fleet), equal to those rows of the whole fleet's embedding
    (embed_nodes)."""
    sc = score_cols if score_cols > 0 else free.shape[1]
    feats = pf.node_features(free[:, :sc], capacity[:, :sc],
                             rt.inv_scale.to(free.device))
    return embed_nodes(rt.params, feats, node_offset, m_total)


def chunk_scores(pod_emb, node_emb, group_id, group_feas, free, req,
                 tau: float, round_key, c: int, chunk: int,
                 node_offset: int = 0, m_total=None):
    """The plain scores of noise block c (rows c * chunk onwards) over the
    nodes node_offset .. node_offset + W of m_total (default W = all):
    (ok [C, W] bool, ls [C, W] float32, u [C, W] float32, NEG_INF where
    not ok), round_key = fold_in(key, rnd); the noise is the (chunk,
    m_total) draw's columns of these nodes."""
    sl = slice(c * chunk, (c + 1) * chunk)
    creq = req[sl]
    W = free.shape[0]
    m_total = W if m_total is None else int(m_total)
    ok = group_feas[group_id[sl].long()]                             # [C, W]
    for r in range(req.shape[1]):
        ok = ok & (free[:, r][None, :] >= creq[:, r][:, None])
    ls = learned_dot(pod_emb[sl], node_emb)                          # [C, W]
    g = prng.gumbel(prng.fold_in(round_key, c), (ls.shape[0], m_total),
                    cols=(node_offset, node_offset + W))
    u = torch.where(ok, ls + tau * g, torch.full_like(ls, NEG_INF))
    return ok, ls, u


def slice_sums(ls_ok: torch.Tensor) -> torch.Tensor:
    """[C, S] float64: the sums of ls_ok [C, W] (ls where ok, else 0) over
    each SLICE_NODES-node slice, the nodes added in order, as the kernel's
    shard part adds them."""
    C, W = ls_ok.shape
    S = -(-W // SLICE_NODES)
    v = torch.zeros((C, S * SLICE_NODES), dtype=torch.float64,
                    device=ls_ok.device)
    v[:, :W] = ls_ok
    v = v.view(C, S, SLICE_NODES)
    acc = torch.zeros((C, S), dtype=torch.float64, device=ls_ok.device)
    for j in range(SLICE_NODES):
        acc = acc + v[:, :, j]
    return acc


def learned_propose_shard_reference(pod_emb, node_emb, group_id, group_feas,
                                    free, req, active, tau: float, key,
                                    rnd: int, chunk: int,
                                    node_offset: int = 0, m_total=None):
    """Plain PyTorch version of the shard part over the nodes node_offset
    .. node_offset + W of m_total (default W), one [chunk, W] block at a
    time. Returns (keys [N] int64: ops/best_nodes.exact_key of the best u
    and its global node, KEY_NONE where no node fits or the row is
    inactive; nf [N] int32; partial [N, ceil(W / SLICE_NODES)] float64, 0
    on inactive rows)."""
    N = req.shape[0]
    W = free.shape[0]
    m_total = W if m_total is None else int(m_total)
    dev = req.device
    round_key = prng.fold_in(key, int(rnd))
    S = -(-W // SLICE_NODES)
    keys, nfs, partials = [], [], []
    for c in range(-(-N // chunk)):
        rows = active[c * chunk:(c + 1) * chunk]
        if not bool(rows.any()):
            # a block with no active row: its outputs are the defaults
            C = rows.shape[0]
            keys.append(torch.full((C,), KEY_NONE, dtype=torch.int64,
                                   device=dev))
            nfs.append(torch.zeros((C,), dtype=torch.int32, device=dev))
            partials.append(torch.zeros((C, S), dtype=torch.float64,
                                        device=dev))
            continue
        ok, ls, u = chunk_scores(pod_emb, node_emb, group_id, group_feas,
                                 free, req, tau, round_key, c, chunk,
                                 node_offset, m_total)
        nfs.append(ok.sum(dim=1, dtype=torch.int32))
        if W:
            best = torch.argmax(u, dim=1)
            top = u.gather(1, best[:, None])[:, 0]
            keys.append(torch.where(
                ok.any(dim=1), exact_key(top, best + node_offset, m_total),
                KEY_NONE))
        else:
            keys.append(torch.full((u.shape[0],), KEY_NONE,
                                   dtype=torch.int64, device=dev))
        partials.append(slice_sums(torch.where(ok, ls, 0.0)))
    if not keys:
        return (torch.zeros((0,), dtype=torch.int64, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0, S), dtype=torch.float64, device=dev))
    keys, nf, partial = (torch.cat(p) for p in (keys, nfs, partials))
    return (torch.where(active, keys, KEY_NONE),
            torch.where(active, nf, 0).to(torch.int32),
            torch.where(active[:, None], partial, 0.0))


def learned_propose_finish_reference(active, pod_emb, node_emb, keys, nf,
                                     partial):
    """Plain PyTorch version of the finish over the merged slots of M =
    node_emb's rows: (prop, pick, nf, lmean) as learned_propose returns
    them."""
    M = node_emb.shape[0]
    total = torch.zeros((keys.shape[0],), dtype=torch.float64,
                        device=keys.device)
    for s in range(partial.shape[1]):
        total = total + partial[:, s]
    lmean = (total / nf.double().clamp(min=1.0)).float()
    found = keys > KEY_NONE
    pick = torch.where(found, M - 1 - (keys & 0xFFFFFFFF), 0)
    if M:
        ne = node_emb[pick.clamp(0, M - 1)]
        ls = pod_emb[:, 0] * ne[:, 0]
        for e in range(1, pod_emb.shape[1]):
            ls = ls + pod_emb[:, e] * ne[:, e]
    else:
        ls = lmean
    good = (nf > 0) & (ls - lmean > pnet.GATE_MARGIN)
    prop = torch.where(good, pick, M)
    return (torch.where(active, prop, M).to(torch.int32),
            torch.where(active, pick, 0).to(torch.int32),
            torch.where(active, nf, 0).to(torch.int32),
            torch.where(active, lmean, 0.0))


def merge_proposals(parts, device):
    """The shard parts' (keys, nf, partial), in shard order, merged on
    `device` (the lead): keys max-merged (ties to the lowest node, -0.0 =
    +0.0, in any shard order), nf added as integers, the slice tables side
    by side. One part is returned as it is."""
    if len(parts) == 1:
        return parts[0]
    keys, nfs, partials = ([p[k].to(device, non_blocking=True) for p in parts]
                           for k in range(3))
    nf = nfs[0]
    for x in nfs[1:]:
        nf = nf + x
    return (torch.stack(keys).amax(dim=0), nf, torch.cat(partials, dim=1))


def learned_propose_reference(pod_emb, node_emb, group_id, group_feas, free,
                              req, active, tau: float, key, rnd: int,
                              chunk: int):
    """Plain PyTorch version of the gated proposal pass over all nodes:
    the shard part's plain version at (0, M) and the finish's. Returns
    (prop [N] int32, M where no override; pick [N] int32; nf [N] int32;
    lmean [N] float32); inactive rows give prop M, pick 0, nf 0, lmean 0."""
    keys, nf, partial = learned_propose_shard_reference(
        pod_emb, node_emb, group_id, group_feas, free, req, active, tau,
        key, rnd, chunk)
    return learned_propose_finish_reference(active, pod_emb, node_emb, keys,
                                            nf, partial)


def _library():
    lib = torchtools.load_library(LIBRARY)
    if not getattr(lib, "_yk_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.yk_learned_propose_shard.argtypes = (
            [p] * 8 + [i, i, ctypes.c_float] + [i] * 7 + [p] * 8)
        lib.yk_learned_propose_shard.restype = i
        lib.yk_learned_propose_finish.argtypes = [p] * 6 + [i] * 4 + [p] * 5
        lib.yk_learned_propose_finish.restype = i
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


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.yk_cuda_error_string(rc).decode())


def _cuda_device(t, what: str):
    """t's device when it takes the kernel (None for the CPU: the plain
    version)."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not "
                         f"{t.device.type}")
    return t.device


def learned_propose_shard(pod_emb, node_emb, group_id, group_feas, free, req,
                          active, tau: float, key, rnd: int, chunk: int,
                          node_offset: int = 0, m_total=None):
    """The shard part over the nodes node_offset .. node_offset + W of
    m_total (default W: all). Shapes: pod_emb [N, E] and node_emb [W, E]
    float32 (E at most 32), group_id [N] int32, group_feas [G, W] bool,
    free [W, R] int32, req [N, R] int32, active [N] bool, key [2] int64
    (utils/prng), rnd the round, chunk the rows of one noise block (N a
    multiple of it).

    Returns (keys [N] int64, nf [N] int32, partial [N, ceil(W /
    SLICE_NODES)] float64) as learned_propose_shard_reference does; the
    kernel leaves partial unwritten on inactive rows. CPU tensors take the
    plain version; CUDA tensors launch the kernel (and add one to
    `learned_propose.launches`)."""
    device = _cuda_device(req, "learned_propose")
    W = free.shape[0]
    m_total = W if m_total is None else int(m_total)
    if node_offset < 0 or m_total < node_offset + W:
        raise ValueError(f"a node shard at offset {node_offset} of {W} "
                         f"nodes does not fit m_total {m_total}")
    if device is None:
        return learned_propose_shard_reference(
            pod_emb, node_emb, group_id, group_feas, free, req, active, tau,
            key, rnd, chunk, node_offset, m_total)
    N, R = req.shape
    G = group_feas.shape[0]
    E = pod_emb.shape[1] if pod_emb.dim() == 2 else -1
    _check("pod_emb", pod_emb, torch.float32, (N, E), device)
    _check("node_emb", node_emb, torch.float32, (W, E), device)
    _check("group_id", group_id, torch.int32, (N,), device)
    _check("group_feas", group_feas, torch.bool, (G, W), device)
    _check("free", free, torch.int32, (W, R), device)
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
    if lib.yk_learned_propose_slice_nodes() != SLICE_NODES:
        raise RuntimeError("the learned_propose library's slice width is "
                           "not SLICE_NODES: rebuild it")
    emb = padded_emb(E)
    pod_emb, node_emb = pad_emb(pod_emb, emb), pad_emb(node_emb, emb)
    i32 = dict(dtype=torch.int32, device=device)
    keys = torch.empty((N,), dtype=torch.int64, device=device)
    nf = torch.empty((N,), **i32)
    partial = torch.empty((N, -(-W // SLICE_NODES)), dtype=torch.float64,
                          device=device)
    if N == 0:
        return keys, nf, partial
    words = torch.empty((G, (W + 31) // 32), **i32)
    chunk_keys = torch.empty((N // chunk, 2), **i32)
    row_list = torch.empty((N,), **i32)
    row_count = torch.empty((1,), **i32)
    # the launch goes to the calling thread's current card: make it the
    # tensors' (a node shard may live on another card than the caller's)
    with torch.cuda.device(device):
        rc = lib.yk_learned_propose_shard(
            req.data_ptr(), group_id.data_ptr(), group_feas.data_ptr(),
            free.data_ptr(), active.data_ptr(), pod_emb.data_ptr(),
            node_emb.data_ptr(), key.data_ptr(), int(rnd), int(chunk),
            float(tau), N, W, int(node_offset), m_total, G, R, emb,
            words.data_ptr(), chunk_keys.data_ptr(), keys.data_ptr(),
            nf.data_ptr(), row_list.data_ptr(), row_count.data_ptr(),
            partial.data_ptr(), torchtools.current_stream_handle(device))
    _raise_on(lib, rc, "learned_propose")
    learned_propose.launches += 1
    return keys, nf, partial


def learned_propose_finish(active, pod_emb, node_emb, keys, nf, partial):
    """The finish over the merged slots (merge_proposals) of M = node_emb's
    rows: active [N] bool, pod_emb [N, E] and node_emb [M, E] float32,
    keys [N] int64, nf [N] int32, partial [N, S] float64, on one device.
    Returns (prop, pick, nf, lmean) as learned_propose_finish_reference
    does. CPU tensors take the plain version; CUDA tensors launch the
    kernel (and add one to `learned_propose_finish.launches`)."""
    device = _cuda_device(keys, "learned_propose_finish")
    if device is None:
        return learned_propose_finish_reference(active, pod_emb, node_emb,
                                                keys, nf, partial)
    N = keys.shape[0]
    M = node_emb.shape[0]
    S = partial.shape[1] if partial.dim() == 2 else -1
    E = pod_emb.shape[1] if pod_emb.dim() == 2 else -1
    _check("active", active, torch.bool, (N,), device)
    _check("pod_emb", pod_emb, torch.float32, (N, E), device)
    _check("node_emb", node_emb, torch.float32, (M, E), device)
    _check("keys", keys, torch.int64, (N,), device)
    _check("nf", nf, torch.int32, (N,), device)
    _check("partial", partial, torch.float64, (N, S), device)
    lib = _library()
    emb = padded_emb(E)
    pod_emb, node_emb = pad_emb(pod_emb, emb), pad_emb(node_emb, emb)
    i32 = dict(dtype=torch.int32, device=device)
    prop = torch.empty((N,), **i32)
    pick = torch.empty((N,), **i32)
    nf_out = torch.empty((N,), **i32)
    lmean = torch.empty((N,), dtype=torch.float32, device=device)
    if N == 0:
        return prop, pick, nf_out, lmean
    with torch.cuda.device(device):
        rc = lib.yk_learned_propose_finish(
            active.data_ptr(), pod_emb.data_ptr(), node_emb.data_ptr(),
            keys.data_ptr(), nf.data_ptr(), partial.data_ptr(), N, M, S,
            emb, prop.data_ptr(), pick.data_ptr(), nf_out.data_ptr(),
            lmean.data_ptr(), torchtools.current_stream_handle(device))
    _raise_on(lib, rc, "learned_propose_finish")
    learned_propose_finish.launches += 1
    return prop, pick, nf_out, lmean


def learned_propose(pod_emb, node_emb, group_id, group_feas, free, req,
                    active, tau: float, key, rnd: int, chunk: int):
    """The gated learned proposal of every active pod over all M nodes:
    learned_propose_shard at (0, M), then learned_propose_finish. Shapes as
    learned_propose_shard's with W = M. Returns (prop, pick, nf, lmean) as
    learned_propose_reference does. CPU tensors take the plain versions;
    CUDA tensors launch the kernel's two parts (one on each launch
    count)."""
    keys, nf, partial = learned_propose_shard(
        pod_emb, node_emb, group_id, group_feas, free, req, active, tau, key,
        rnd, chunk)
    return learned_propose_finish(active, pod_emb, node_emb, keys, nf,
                                  partial)


learned_propose.launches = 0
learned_propose_finish.launches = 0
