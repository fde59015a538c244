"""The pack arm's rounding pick: for every ask of every part, the node it
samples by Gumbel-max over its rounding scores among the nodes it fits, as
an exact key (ops/best_nodes.exact_key), once a rounding round of
ops/pack_solve `_round_part`.

On CUDA tensors `pack_pick` launches the hand-written kernel in
`csrc/pack_pick.cu`; on CPU tensors it takes `pack_pick_reference`, the
plain PyTorch version of the same function. There is no fallback between
the two: a CUDA call launches the kernel or raises.

A call covers one piece of the node axis, the nodes lo .. lo + w of m: the
whole of a part's nodes (lo 0, w = m), or a node shard's window (the cvx
arm under a mesh). The Gumbel noise is utils/prng.gumbel's draw of shape
(n, m) under each part's round key, at the piece's columns, so the pieces'
keys merged by ops/best_nodes.merge_keys give the one call's over all m
nodes, bit for bit. The kernel never stores the [K, n, w] noise.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from yunikorn_tpu_torch.ops.best_nodes import (KEY_NONE, NEG_INF, _check,
                                               exact_key)
from yunikorn_tpu_torch.utils import prng, torchtools

# the kernel's library: csrc/<LIBRARY>.cu, built by utils/torchtools
LIBRARY = "pack_pick"

# each thread's launches (a pack solve runs on one thread)
_local = threading.local()


def thread_launches() -> int:
    """The kernel's launches made on the calling thread so far: a solve
    counts its own as the difference across it."""
    return getattr(_local, "launches", 0)


def pack_pick_reference(feas, scores, cur, req, tb, keys, lo: int, m: int,
                        inv_tau: float):
    """Plain PyTorch version of `pack_pick` (same arguments): the fit
    margin, the masked Gumbel argmax and its gather over the [K, n, w]
    pairs, each float operation rounded on its own."""
    K, n, w = scores.shape
    R = cur.shape[-1]
    cur3 = cur.view(K, 1, w, R)
    margin = cur3[..., 0] - req[:, :, None, 0]
    for r in range(1, R):
        margin = torch.minimum(margin, cur3[..., r] - req[:, :, None, r])
    ok = feas & (margin >= 0)
    u = (scores + tb[:, None, :]) * inv_tau
    noise = prng.gumbel(keys, (n, m), cols=(lo, lo + w))
    masked = torch.where(ok, u + noise, NEG_INF)
    best = torch.argmax(masked, dim=2)                          # [K, n]
    top = masked.gather(2, best[..., None])[..., 0]
    return torch.where(ok.any(dim=2), exact_key(top, best + lo, m), KEY_NONE)


def _library():
    lib = torchtools.load_library(LIBRARY)
    if not getattr(lib, "_yk_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.yk_pack_pick.argtypes = [p] * 6 + [i] * 6 + [ctypes.c_float, p, p]
        lib.yk_pack_pick.restype = i
        lib.yk_pack_pick_max_res.restype = i
        lib.yk_cuda_error_string.argtypes = [i]
        lib.yk_cuda_error_string.restype = ctypes.c_char_p
        lib._yk_typed = True
    return lib


def pack_pick(feas, scores, cur, req, tb, keys, lo: int, m: int,
              inv_tau: float):
    """Each row's key of its best fitting node in the piece lo .. lo + w of
    m nodes. Shapes: feas [K, n, w] bool, scores [K, n, w] float32, cur
    [K, w, R] int32 (the piece's free capacity), req [K, n, R] int32, tb
    [K, w] float32 (the base-score tiebreak), keys [K, 2] int64 (each
    part's round key, utils/prng). A row's value on node j is
    fl(fl(scores + tb) * inv_tau) plus its Gumbel noise.

    Returns [K, n] int64: the exact key of the best value and its global
    node, KEY_NONE where no node of the piece fits. CPU tensors take the
    plain version; CUDA tensors launch the kernel (and add one to
    `pack_pick.launches` and to the thread's count)."""
    device = scores.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"pack_pick runs on cuda or cpu tensors, not "
                         f"{device.type}")
    K, n, w = scores.shape
    R = cur.shape[-1] if cur.dim() == 3 else -1
    _check("feas", feas, torch.bool, (K, n, w), device)
    _check("scores", scores, torch.float32, (K, n, w), device)
    _check("cur", cur, torch.int32, (K, w, R), device)
    _check("req", req, torch.int32, (K, n, R), device)
    _check("tb", tb, torch.float32, (K, w), device)
    _check("keys", keys, torch.int64, (K, 2), device)
    if lo < 0 or m < lo + w:
        raise ValueError(f"a piece of {w} nodes at {lo} does not fit {m}")
    if device.type == "cpu":
        return pack_pick_reference(feas, scores, cur, req, tb, keys, lo, m,
                                   inv_tau)
    lib = _library()
    if not 1 <= R <= lib.yk_pack_pick_max_res():
        raise ValueError(f"pack_pick takes 1 to {lib.yk_pack_pick_max_res()} "
                         f"resource columns, got {R}")
    out = torch.empty((K, n), dtype=torch.int64, device=device)
    if K == 0 or n == 0:
        return out
    # the launch goes to the calling thread's current card: make it the
    # tensors' (a node shard may live on another card than the caller's)
    with torch.cuda.device(device):
        rc = lib.yk_pack_pick(
            feas.data_ptr(), scores.data_ptr(), cur.data_ptr(),
            req.data_ptr(), tb.data_ptr(), keys.data_ptr(), K, n, w, R,
            int(lo), int(m), float(inv_tau), out.data_ptr(),
            torchtools.current_stream_handle(device))
    if rc != 0:
        raise RuntimeError("pack_pick kernel launch failed: "
                           + lib.yk_cuda_error_string(rc).decode())
    pack_pick.launches += 1
    _local.launches = thread_launches() + 1
    return out


pack_pick.launches = 0
