"""Every pod's best node: fused fit + group mask + score + argmax.

The port's counterpart of the JAX package's ops/pallas_kernels.py. On CUDA
tensors `best_nodes` launches the hand-written kernel in
`csrc/best_nodes.cu`; on CPU tensors it takes `best_nodes_reference`, the
plain PyTorch version of the same function. There is no fallback between the
two: a CUDA call launches the kernel or raises.

Modes (a static choice, as the two solve paths of the JAX package are):
  exact      bit-equal to the plain argmax of ops/assign `_best_nodes_chunked`
             — the solve's default.
  quantized  bit-equal to the Pallas kernel `pallas_best_nodes`: scores
             quantized to 1/128 and packed with the node index into one int32
             — what `use_pallas=True` selects.

has_soft=False leaves the [G, M] soft matrix out (the kernel takes no soft
pointer); the solve selects it only when the soft matrix is all zeros.

rows, a [N] bool mask, restricts the work to the rows the caller needs
(the solve's odd rounds pass the active pods whose proposal does not fit);
the other rows come back as best 0, feasible False on both devices.

The planned-domain bonus (topology steering): given node_dom [M] int32 (the
node's ICI domain, -1 unlabeled) and pref [N] int32 (the pod's planned
domain, -1 none), a pod's score on a node of its planned domain is
fl(fl(base + soft) + TOPO_GANG_W), elsewhere fl(base + soft) + 0.0, as the
reference's steered argmax adds it. The score then depends on the pod, not
only on its group. The bonus runs in the exact mode only (the reference's
steered rounds take its plain argmax, never the Pallas kernel).

The learned term (solver.policy=learned): given pod_emb [N, E] and node_emb
[M, E] float32, a pod's score on a node is fl(s + ls), s the score above
(with the bonus when it applies) and ls = `learned_dot`, the embeddings'
dot product with e in order and each product and sum rounded, as the
reference's learned argmax adds its [C, E] x [E, M] term. Exact mode with
the soft matrix only (the reference's learned argmax never takes the
Pallas kernel).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from yunikorn_tpu_torch.utils import torchtools

NEG_INF = -3.0e38
SCORE_SCALE = 128.0
PACKED_MIN = -(1 << 30)
MODES = ("exact", "quantized")
_POD_CHUNK = 512
# the kernel's library: csrc/<LIBRARY>.cu, built by utils/torchtools
LIBRARY = "best_nodes"
# the per-pod planned-domain bonus of topology steering: it dominates
# base-score differences (scores are base in [0, 1] plus soft terms of that
# scale) without overriding feasibility
TOPO_GANG_W = 8.0


def index_span(m: int) -> int:
    """Room for node indices below the quantized score: the smallest power
    of two strictly greater than m, at least 2^10 (the Pallas kernel's
    `_index_span`)."""
    return 1 << max(10, m.bit_length())


def pref_bonus(node_dom, pref):
    """[C, M] float32: TOPO_GANG_W where node j lies in row i's planned
    domain (pref[i] >= 0, node_dom[j] >= 0 and equal), else 0.0."""
    in_pref = ((pref[:, None] >= 0) & (node_dom[None, :] >= 0)
               & (node_dom[None, :] == pref[:, None]))
    return torch.where(in_pref, TOPO_GANG_W, 0.0)


def learned_dot(pod_emb, node_emb):
    """[C, M] float32: sum over e of pod_emb[i, e] * node_emb[j, e], e in
    order, each product and each sum rounded to float32 (no fused
    multiply-add): the learned term as both kernels compute it."""
    acc = pod_emb[:, 0:1] * node_emb[None, :, 0]
    for e in range(1, pod_emb.shape[1]):
        acc = acc + pod_emb[:, e:e + 1] * node_emb[None, :, e]
    return acc


def _check_learned(mode, has_soft, pod_emb, node_emb):
    """Whether the learned term applies; raises on half a pair, the
    quantized mode or a call without the soft matrix."""
    if (pod_emb is None) != (node_emb is None):
        raise ValueError("pod_emb and node_emb go together: give both or "
                         "neither")
    if pod_emb is not None and (mode != "exact" or not has_soft):
        raise ValueError("the learned term runs in the exact mode with the "
                         "soft matrix")
    return pod_emb is not None


def _check_bonus(mode, node_dom, pref):
    """Whether the planned-domain bonus applies; raises on half a pair or
    the quantized mode."""
    if (node_dom is None) != (pref is None):
        raise ValueError("node_dom and pref go together: give both or "
                         "neither")
    if node_dom is not None and mode != "exact":
        raise ValueError("the planned-domain bonus runs in the exact mode")
    return node_dom is not None


def best_nodes_reference(req, group_id, group_feas, group_soft, free,
                         base_scores, *, mode: str = "exact",
                         has_soft: bool = True, chunk: int = _POD_CHUNK,
                         rows: Optional[torch.Tensor] = None,
                         node_dom: Optional[torch.Tensor] = None,
                         pref: Optional[torch.Tensor] = None,
                         pod_emb: Optional[torch.Tensor] = None,
                         node_emb: Optional[torch.Tensor] = None):
    """Plain PyTorch version of both modes, the bonus and the learned term,
    chunked over pods so no [N, M] tensor is built. Returns (best [N]
    int32, feasible [N] bool)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    bonus = _check_bonus(mode, node_dom, pref)
    learned = _check_learned(mode, has_soft, pod_emb, node_emb)
    if rows is not None:
        # the requested rows at their places, 0 / False elsewhere
        best = torch.zeros(rows.shape, dtype=torch.int32, device=rows.device)
        feasible = torch.zeros(rows.shape, dtype=torch.bool,
                               device=rows.device)
        best[rows], feasible[rows] = best_nodes_reference(
            req[rows], group_id[rows], group_feas, group_soft, free,
            base_scores, mode=mode, has_soft=has_soft, chunk=chunk,
            node_dom=node_dom, pref=pref[rows] if bonus else None,
            pod_emb=pod_emb[rows] if learned else None, node_emb=node_emb)
        return best, feasible
    N, R = req.shape
    M = free.shape[0]
    span = index_span(M)
    col = torch.arange(M, device=req.device, dtype=torch.int64)
    best_parts, feas_parts = [], []
    for start in range(0, N, chunk):
        creq = req[start:start + chunk]
        cgid = group_id[start:start + chunk].long()
        ok = group_feas[cgid]                                      # [C, M]
        for r in range(R):
            ok = ok & (free[:, r][None, :] >= creq[:, r][:, None])
        if has_soft:
            scores = base_scores[None, :] + group_soft[cgid]
        else:
            scores = base_scores[None, :].expand(creq.shape[0], M)
        if bonus:
            scores = scores + pref_bonus(node_dom, pref[start:start + chunk])
        if learned:
            scores = scores + learned_dot(pod_emb[start:start + chunk],
                                          node_emb)
        if mode == "exact":
            masked = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
            best = torch.argmax(masked, dim=1)
            feasible = ok.any(dim=1)
        else:
            q = torch.round(scores * SCORE_SCALE).to(torch.int32).long()
            packed = q * span + (M - col)[None, :]
            packed = (packed + 2**31) % 2**32 - 2**31              # int32 wrap
            packed = torch.where(ok, packed,
                                 torch.full_like(packed, PACKED_MIN))
            top = packed.max(dim=1).values if M else torch.full(
                (creq.shape[0],), PACKED_MIN, dtype=torch.int64,
                device=req.device)
            feasible = top > PACKED_MIN
            best = torch.where(feasible, M - torch.remainder(top, span),
                               torch.zeros_like(top))
        best_parts.append(best.to(torch.int32))
        feas_parts.append(feasible)
    if not best_parts:
        return (torch.zeros((0,), dtype=torch.int32, device=req.device),
                torch.zeros((0,), dtype=torch.bool, device=req.device))
    return torch.cat(best_parts), torch.cat(feas_parts)


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _library():
    lib = torchtools.load_library(LIBRARY)
    if not getattr(lib, "_yk_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.yk_best_nodes.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i,
                                      i, i, i, i, i, i, p, p, p, p, p, p, p,
                                      p, p]
        lib.yk_best_nodes.restype = i
        lib.yk_best_nodes_max_res.restype = i
        lib.yk_best_nodes_slice_nodes.restype = i
        lib.yk_cuda_error_string.argtypes = [i]
        lib.yk_cuda_error_string.restype = ctypes.c_char_p
        lib._yk_typed = True
    return lib


# embedding widths the kernels take; a narrower embedding is zero-padded
# (a padded term adds 0.0 to the dot product, which changes no value)
EMB_WIDTHS = (16, 32)


def padded_emb(E: int) -> int:
    """The kernel width an embedding of width E runs at (raises above the
    widest)."""
    for w in EMB_WIDTHS:
        if 1 <= E <= w:
            return w
    raise ValueError(f"the kernels take embeddings of width 1 to "
                     f"{EMB_WIDTHS[-1]}, got {E}")


def pad_emb(x: torch.Tensor, width: int) -> torch.Tensor:
    """[K, E] float32 -> contiguous [K, width], zero columns appended."""
    if x.shape[1] == width:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, width - x.shape[1])).contiguous()


def slice_nodes() -> int:
    """Nodes per block slice of the kernel: it splits the node range across
    blocks at multiples of this."""
    return _library().yk_best_nodes_slice_nodes()


def best_nodes(req, group_id, group_feas, group_soft, free, base_scores, *,
               mode: str = "exact", has_soft: bool = True,
               chunk: int = _POD_CHUNK, rows: Optional[torch.Tensor] = None,
               node_dom: Optional[torch.Tensor] = None,
               pref: Optional[torch.Tensor] = None,
               pod_emb: Optional[torch.Tensor] = None,
               node_emb: Optional[torch.Tensor] = None):
    """Best node per pod. Shapes: req [N, R] int32, group_id [N] int32,
    group_feas [G, M] bool, group_soft [G, M] float32 (ignored when
    has_soft=False), free [M, R] int32, base_scores [M] float32; rows
    (optional) [N] bool, the rows to compute (the kernel counts them on the
    device: nothing is read back); node_dom [M] int32 and pref [N] int32
    (optional, both or neither, exact mode): the planned-domain bonus;
    pod_emb [N, E] and node_emb [M, E] float32 (optional, both or neither,
    exact mode with the soft matrix, E at most 32): the learned term.

    Returns (best [N] int32, feasible [N] bool), best = 0 where no node is
    feasible or the row was not requested. CPU tensors take the plain
    version; CUDA tensors launch the kernel (and add one to
    `best_nodes.launches`)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    bonus = _check_bonus(mode, node_dom, pref)
    learned = _check_learned(mode, has_soft, pod_emb, node_emb)
    device = req.device
    if device.type == "cpu":
        return best_nodes_reference(req, group_id, group_feas, group_soft,
                                    free, base_scores, mode=mode,
                                    has_soft=has_soft, chunk=chunk,
                                    rows=rows, node_dom=node_dom, pref=pref,
                                    pod_emb=pod_emb, node_emb=node_emb)
    if device.type != "cuda":
        raise ValueError(f"best_nodes runs on cuda or cpu tensors, not "
                         f"{device.type}")
    N, R = req.shape
    G, M = group_feas.shape
    _check("req", req, torch.int32, (N, R), device)
    _check("group_id", group_id, torch.int32, (N,), device)
    _check("group_feas", group_feas, torch.bool, (G, M), device)
    if has_soft:
        _check("group_soft", group_soft, torch.float32, (G, M), device)
    _check("free", free, torch.int32, (M, R), device)
    _check("base_scores", base_scores, torch.float32, (M,), device)
    if rows is not None:
        _check("rows", rows, torch.bool, (N,), device)
    if bonus:
        _check("node_dom", node_dom, torch.int32, (M,), device)
        _check("pref", pref, torch.int32, (N,), device)
    emb = 0
    if learned:
        E = pod_emb.shape[1] if pod_emb.dim() == 2 else -1
        _check("pod_emb", pod_emb, torch.float32, (N, E), device)
        _check("node_emb", node_emb, torch.float32, (M, E), device)
        emb = padded_emb(E)
        pod_emb, node_emb = pad_emb(pod_emb, emb), pad_emb(node_emb, emb)
    if G < 1:
        raise ValueError("group_feas needs at least one group row")
    lib = _library()
    if R > lib.yk_best_nodes_max_res():
        raise ValueError(f"best_nodes takes at most "
                         f"{lib.yk_best_nodes_max_res()} resource columns, "
                         f"got {R}")
    best = torch.empty((N,), dtype=torch.int32, device=device)
    feasible = torch.empty((N,), dtype=torch.bool, device=device)
    if N == 0:
        return best, feasible
    key_dtype = torch.int32 if mode == "quantized" else torch.int64
    n_words = (M + 31) // 32
    keys = torch.empty((G, n_words * 32), dtype=key_dtype, device=device)
    # the bonus variant's second key table: the keys of fl(s + TOPO_GANG_W)
    bonus_keys = torch.empty_like(keys) if bonus else None
    words = torch.empty((G, n_words), dtype=torch.int32, device=device)
    row_best = torch.empty((N,), dtype=key_dtype, device=device)
    # the kernel compacts the requested rows into row_list, counting them in
    # row_count, on the device: nothing is read back to the host
    row_list = torch.empty((N if rows is not None else 0,),
                           dtype=torch.int32, device=device)
    row_count = torch.empty((1,), dtype=torch.int32, device=device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.yk_best_nodes(
        req.data_ptr(), group_id.data_ptr(), group_feas.data_ptr(),
        group_soft.data_ptr() if has_soft else None, free.data_ptr(),
        base_scores.data_ptr(), ptr(rows), ptr(node_dom), ptr(pref),
        ptr(pod_emb), ptr(node_emb), emb,
        N, M, G, R, int(has_soft), int(mode == "quantized"),
        index_span(M), keys.data_ptr(), ptr(bonus_keys), words.data_ptr(),
        row_best.data_ptr(), row_list.data_ptr(), row_count.data_ptr(),
        best.data_ptr(), feasible.data_ptr(),
        torchtools.current_stream_handle(device))
    if rc != 0:
        raise RuntimeError("best_nodes kernel launch failed: "
                           + lib.yk_cuda_error_string(rc).decode())
    best_nodes.launches += 1
    return best, feasible


best_nodes.launches = 0
