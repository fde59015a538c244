"""Device-resident admission gate and request-row quantization: the JAX
package's ops/gate_solve.py in PyTorch.

The host array scan (core/gate.host_scan) decides a cycle's admissions in
segmented prefix-scan passes whose count depends on the data. This module
runs the same scan on the core's device as torch ops over fixed, padded
row-level shapes, with a pass budget bounded by construction:

  max_passes = ceil(log2(n_pad)) + GATE_PASS_SLACK

The pass loop is a Python loop whose exit test (any undecided row left?)
is one host read a pass, so a scan synchronises at most passes + 1 times.
Leftovers past the cap are decided exactly on the host by
core/gate.finish_leftovers, O(leftovers).

Formulation (the reference's, unchanged): no scatters — every ask-level
OR runs as a segmented 1-D cumsum over a precomputed ask-sorted
permutation of the membership rows, broadcast back with gathers; status
lives at row granularity (all rows of an ask agree) and the [n] ask vector
is reassembled on the host; two segmented [M, K] cumsums a pass, the
admitted-only prefix right after the pass's admissions and the not-held
prefix after the definite-hold sweep.

Exactness: integer arithmetic throughout. The scan runs in int32 when the
cycle's worst-case prefix sum and finite budgets provably fit (fits32),
else in int64; every cumsum names its dtype, so torch's promotion of int32
sums to int64 never applies. Both dtype paths decide identically.

encode_rows / gather_rows are the request-row pool's device half
(snapshot/encoder.DeviceRowStore): raw rows quantize on the device with the
host chain's arithmetic (float64 divide, ceil, float32, int32 with XLA's
saturating conversion) and scatter into the pool; a batch's req tensor is a
gather of slot indices.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from yunikorn_tpu_torch.core import gate as gate_mod
from yunikorn_tpu_torch.snapshot.vocab import _next_pow2
from yunikorn_tpu_torch.utils.torchtools import resolve_device

# extra passes past ceil(log2(n_pad)): covers the small non-logarithmic tail
# real traces show (the saturated 50k shape converges in ~13-14 where
# ceil(log2(65536)) alone allows 16)
GATE_PASS_SLACK = 4

_INF = gate_mod._INF
# int32 path: every magnitude stays below this, and unconstrained budgets
# become it (strictly above any reachable prefix)
_I32CAP = np.int64(1) << 30
_I32_MAX = 2**31 - 1
# the largest float32 below 2^31
_F32_BELOW_2_31 = 2147483520.0


def max_passes_for(n: int) -> int:
    """The pass budget for a batch of n asks (after bucketing)."""
    n_pad = _next_pow2(max(n, 1), 256)
    return max(int(math.ceil(math.log2(n_pad))), 1) + GATE_PASS_SLACK


def _gate_scan(reqw, bm2, rstatus0, seg_first_t, perm_a, inv_perm_a,
               seg_first_a, seg_last_a, *, max_passes: int):
    """Masked bounded-pass admission over padded row-level tensors, all on
    one device.

    reqw      [M, K] int32/int64  weighted charge per membership row
    bm2       [M, K] same dtype   budget minus own request per row
    rstatus0  [M] int8            0 undecided / 1 decided (pads)
    seg_first_t [M] int32         first row of this row's TRACKER segment
    perm_a / inv_perm_a / seg_first_a / seg_last_a [M] int32
                                  ask-sorted view: permutation, its
                                  inverse, and per-row first/last index of
                                  the row's ASK segment in the sorted view

    Returns (rstatus [M] int8 with -1 = held, passes).

    The [M, K] charge and budget tensors are held column-major ([K, M]) so
    that every prefix sum is a 1-D scan over one contiguous column: on the
    card torch scans along a non-innermost axis with a few long serial
    loops (tens of ms at M = 2^18)."""
    dev = reqw.device
    admit = torch.ones((), dtype=torch.int8, device=dev)
    hold = torch.full((), -1, dtype=torch.int8, device=dev)
    zero = torch.zeros((), dtype=reqw.dtype, device=dev)
    reqw, bm2 = reqw.t().contiguous(), bm2.t().contiguous()     # [K, M]
    seg_first_t, perm_a, inv_perm_a, seg_first_a, seg_last_a = (
        t.long() for t in (seg_first_t, perm_a, inv_perm_a, seg_first_a,
                           seg_last_a))

    def seg_excl(mask):
        """Segmented EXCLUSIVE cumsum of the rows' charges where `mask`
        holds ([M] bool → [K, M])."""
        X = torch.where(mask[None, :], reqw, zero)
        base = torch.empty_like(X)
        for k in range(X.shape[0]):
            torch.cumsum(X[k], 0, dtype=X.dtype, out=base[k])
        base -= X
        return base - base.index_select(1, seg_first_t)

    def ask_any(flag):
        """Per-ask OR of a row-level flag broadcast back to its rows."""
        s = flag.to(torch.int32).index_select(0, perm_a)
        cs = torch.cumsum(s, 0, dtype=torch.int32)
        tot = (cs.index_select(0, seg_last_a) - cs.index_select(0, seg_first_a)
               + s.index_select(0, seg_first_a))
        return tot.index_select(0, inv_perm_a) > 0

    rstatus = rstatus0
    ov = seg_excl(rstatus != -1)
    passes = 0
    while passes < max_passes and bool((rstatus == 0).any()):
        undec = rstatus == 0
        # violator: the over-estimate (every not-yet-held predecessor plus
        # the own row) exceeds a budget in some tracker
        va = ask_any(undec & (ov > bm2).any(dim=0))
        # every undecided non-violator admits
        rstatus = torch.where(undec & ~va, admit, rstatus)
        # a violator holds iff no earlier violator shares a tracker with it
        # (its prefix is then exact); otherwise it defers
        vr = (va & undec).to(torch.int32)
        cs = torch.cumsum(vr, 0, dtype=torch.int32) - vr
        blocked = ask_any(undec & ((cs - cs.index_select(0, seg_first_t)) > 0))
        rstatus = torch.where(undec & va & ~blocked, hold, rstatus)
        # definite-hold sweep against the admitted prefix including this
        # pass's admissions: admitted usage only grows
        ad = seg_excl(rstatus == 1)
        live = rstatus == 0
        sa = ask_any(live & (ad > bm2).any(dim=0))
        rstatus = torch.where(live & sa, hold, rstatus)
        # the next pass's over-estimate excludes every hold taken so far
        ov = seg_excl(rstatus != -1)
        passes += 1
    return rstatus, passes


def _ask_view(mem_pos: np.ndarray, M_pad: int):
    """Static index arrays for the scan's ask-sorted aggregation view.

    Rows arrive (tracker, pos)-sorted; the stable argsort by ask position
    makes each ask's rows contiguous. Padded rows keep their identity slots
    (each its own segment)."""
    M = mem_pos.shape[0]
    perm = np.arange(M_pad, dtype=np.int64)
    perm[:M] = np.argsort(mem_pos, kind="stable")
    sorted_pos = np.full((M_pad,), -1, np.int64)
    sorted_pos[:M] = mem_pos[perm[:M]]
    # mark pads as distinct pseudo-asks so segments never span the boundary
    if M_pad > M:
        sorted_pos[M:] = -np.arange(2, M_pad - M + 2)
    is_start = np.r_[True, sorted_pos[1:] != sorted_pos[:-1]]
    idx = np.arange(M_pad)
    seg_first = np.maximum.accumulate(np.where(is_start, idx, 0))
    seg_last = np.full((M_pad,), M_pad - 1, np.int64)
    seg_last[:-1] = np.where(is_start[1:], idx[:-1], M_pad - 1)
    np.minimum.accumulate(seg_last[::-1], out=seg_last[::-1])
    inv = np.empty((M_pad,), np.int64)
    inv[perm] = idx
    return (perm.astype(np.int32), inv.astype(np.int32),
            seg_first.astype(np.int32), seg_last.astype(np.int32))


def scan_arrays(problem: "gate_mod.GateProblem", wide=None):
    """The scan's host inputs for a problem with trackers: (reqw, bm2,
    rstatus0, seg_first_t, perm_a, inv_perm_a, seg_first_a, seg_last_a),
    padded to power-of-two buckets. The charge dtype is the narrowest exact
    one (int32 when fits32) unless `wide` forces int64 (True) or int32
    (False)."""
    M = problem.mem_tr.size
    M_pad = _next_pow2(M, 256)
    K = problem.K
    K_pad = _next_pow2(K, 2)
    # loop-invariant row tensors, gathered on the host once per cycle
    rrow = problem.Rm[problem.mem_pos]                    # [M, K]
    wcharge = rrow * problem.mem_w[:, None]
    braw = problem.B[problem.mem_tr] - rrow               # budget minus own
    col_sums = wcharge.sum(axis=0, dtype=np.int64)
    finite = np.abs(braw) < (_INF >> 1)
    if wide is None:
        wide = not (int(col_sums.max(initial=0)) < _I32CAP
                    and (np.abs(braw[finite]).max(initial=0) if finite.any()
                         else 0) < _I32CAP)
    dtype = np.int64 if wide else np.int32
    inf_sentinel = _INF if wide else _I32CAP

    reqw = np.zeros((M_pad, K_pad), dtype)
    reqw[:M, :K] = wcharge
    bm2 = np.full((M_pad, K_pad), inf_sentinel, dtype)
    bm2[:M, :K] = np.where(finite, braw, inf_sentinel)
    rstatus0 = np.ones((M_pad,), np.int8)                 # pads decided
    rstatus0[:M] = problem.status0[problem.mem_pos]
    # tracker-segment starts (rows arrive tracker-major); pads are solo
    is_start = np.empty((M_pad,), bool)
    is_start[0] = True
    is_start[1:M] = problem.mem_tr[1:] != problem.mem_tr[:-1]
    is_start[M:] = True
    idx = np.arange(M_pad)
    seg_first_t = np.maximum.accumulate(
        np.where(is_start, idx, 0)).astype(np.int32)
    return (reqw, bm2, rstatus0, seg_first_t) + _ask_view(problem.mem_pos,
                                                          M_pad)


def device_admit(problem: "gate_mod.GateProblem", *, device=None):
    """Run a GateProblem through the bounded-pass scan on `device` (default
    `cuda`).

    Returns (admitted, held, stats) with the contract of
    core/gate.host_scan; stats["path"] == "device", with passes,
    max_passes, finish_loop, admit_ms, device_ms (the scan from upload to
    read back) and transfer_bytes (the host arrays uploaded)."""
    device = resolve_device(device)
    n, T = problem.n, problem.T
    t_start = time.perf_counter()
    if n == 0:
        return [], 0, {"path": "device", "passes": 0, "trackers": 0}
    base_stats = {
        "path": "device", "trackers": T,
        "rank_ms": (problem.t_rank - problem.t0) * 1000,
    }
    M = problem.mem_tr.size
    if T == 0 or M == 0:
        # pure ranking: nothing to scan
        admitted = [problem.asks_ord[pos]
                    for pos in np.flatnonzero(problem.status0 == 1).tolist()]
        return admitted, 0, dict(
            base_stats, passes=0,
            admit_ms=(time.perf_counter() - problem.t_rank) * 1000)

    max_passes = max_passes_for(n)
    host_arrays = scan_arrays(problem)
    args = [torch.from_numpy(a).to(device) for a in host_arrays]
    rstatus_t, passes = _gate_scan(*args, max_passes=max_passes)
    rstatus = rstatus_t.cpu().numpy()[:M]

    # reassemble the per-ask status (all rows of an ask agree)
    status = problem.status0.copy()
    status[problem.mem_pos] = rstatus
    finish = gate_mod.finish_leftovers(problem, status)
    admitted = [problem.asks_ord[pos]
                for pos in np.flatnonzero(status == 1).tolist()]
    held = int((status == -1).sum())
    return admitted, held, dict(
        base_stats,
        passes=passes,
        max_passes=max_passes,
        finish_loop=finish,
        admit_ms=(time.perf_counter() - problem.t_rank) * 1000,
        device_ms=(time.perf_counter() - t_start) * 1000,
        transfer_bytes=int(sum(a.nbytes for a in host_arrays)),
    )


# --------------------------------------------------------------- encode_rows
def quantize_rows(raw: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[C, R] int64 raw values and [R] float64 scales → [C, R] int32 device
    units: float64 divide (round to nearest), ceil, float32, then int32
    with XLA's saturating conversion (a value at or past 2^31 becomes
    2^31 - 1, one below -2^31 becomes -2^31; a bare cast would wrap on the
    CPU)."""
    q = torch.ceil(raw.to(torch.float64) / scales[None, :]).to(torch.float32)
    rows = q.clamp(-2.0**31, _F32_BELOW_2_31).to(torch.int32)
    return torch.where(q >= 2.0**31, torch.full_like(rows, _I32_MAX), rows)


def encode_rows(pool: torch.Tensor, raw: torch.Tensor, scales: torch.Tensor,
                slots: torch.Tensor) -> torch.Tensor:
    """Quantize raw rows and write them into the row pool in place.

    pool   [cap, R] int32   persistent quantized rows
    raw    [C, R]  int64    raw resource values of changed rows (0 pads,
                            which point at the reserved all-zero slot 0)
    scales [R]     float64  per-slot device-unit scales
    slots  [C]     int32    target pool slot per row
    Returns pool."""
    return pool.index_copy_(0, slots.long(), quantize_rows(raw, scales))


def gather_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, R] int32 request tensor for one batch: each ask's pool slot (0 =
    the reserved zero row for padding), a new tensor."""
    return pool.index_select(0, idx.long())


# ---------------------------------------------------------------------------
# Device-resident usage mirror ops (ops/ledger_mirror.DeviceUsageMirror)
# ---------------------------------------------------------------------------
def usage_apply(dev: torch.Tensor, shard: int, t_idx: torch.Tensor,
                k_idx: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Scatter one shard's drained confirmed-usage deltas into its row of
    the [S, T, K] int64 mirror, in place: dev[shard, t_idx[b], k_idx[b]]
    += deltas[b]. Padded entries carry delta 0 at index (0, 0), where the
    add is the identity. Integer adds are exact in any order, so repeated
    indices accumulate to the same value however the device orders them."""
    shard_idx = torch.full_like(t_idx, int(shard))
    return dev.index_put_((shard_idx, t_idx, k_idx), deltas, accumulate=True)


def usage_fold(dev: torch.Tensor) -> torch.Tensor:
    """Fleet usage: the [S, T, K] mirror summed over the shard axis to the
    [T, K] totals every shard's gate precheck reads (int64)."""
    return dev.sum(dim=0, dtype=torch.int64)
