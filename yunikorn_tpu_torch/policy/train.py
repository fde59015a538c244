"""Offline DOPPLER-style training from recorded duel datasets, on a device.

Training data is the per-cycle duel record the scheduler itself produces
(`CoreScheduler.policy_recorder` set to a `DatasetWriter`): the RAW solve
tensors of one cycle — quantized request rows, round-0 free capacity, node
capacities and validity, priorities — plus every candidate plan that
entered the `choose_plan_n` duel and the duel's winner. Recording raw
tensors (not features) keeps datasets valid across feature-schema bumps:
the trainer derives features with the SAME `policy/features.py` functions
inference uses, so train/serve skew is structurally impossible.

Two phases (`fit`):

  imitation   cross-entropy of the scorer's per-pod node distribution
              against the recorded duel WINNER's assignment, masked to
              fit-feasible nodes.
  fine-tune   a differentiable relaxation of the packing objective itself:
              soft-assign each ask across its feasible nodes (softmax with
              an always-available null column, the pack LP's drop-out
              semantics), maximize expected capacity-normalized placed
              units minus per-node-per-resource overload and a mild
              contention penalty on busy nodes.

Feasibility in the dataset is FIT feasibility (free >= request, node
schedulable); the solver re-checks full group feasibility at inference, so
an over-permissive training mask can only cost score quality.

The JAX package's policy/train.py, ported. The dataset format is the same
file for file and key for key, so a dataset written by either package loads
in the other. `_prepare` builds the [N, M] fit mask and the targets on the
device; the losses are torch functions whose gradients come from autograd;
the optimizer is the same hand-written Adam as torch ops on the device, and
`fit` returns host-form params for `net.save_checkpoint`.

Determinism: the same dataset, seed, hyperparameters and device give
byte-identical params. The imitation loss gathers each row's target logit
through a one-hot compare rather than an indexed gather, whose backward
would scatter through float atomics; no op of either loss or its backward
adds in a data-dependent order. Matrix products run in full float32 (TF32
off for the fit). Params are not bit-equal to the JAX package's: Adam
divides by sqrt(v), and on the node tower's output bias, whose imitation
gradient is exactly zero (a per-row shift the softmax ignores), each
library's rounding noise becomes a full learning-rate step.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from yunikorn_tpu_torch.policy import features as pf
from yunikorn_tpu_torch.policy import net as pnet
from yunikorn_tpu_torch.utils.torchtools import resolve_device


_MASK = -1.0e9


# ---------------------------------------------------------------- dataset IO
_ARRAY_KEYS = ("req", "rank", "valid", "free0", "cap", "node_ok",
               "priorities")


class DatasetWriter:
    """Append per-cycle duel examples as one .npz each + a manifest.jsonl.
    Bounded (max_cycles) so a long replay cannot fill the disk; callable so
    it plugs straight into CoreScheduler.policy_recorder."""

    def __init__(self, path: str, max_cycles: int = 512,
                 fresh: bool = True):
        self.path = path
        self.max_cycles = int(max_cycles)
        self.written = 0
        self.dropped = 0
        os.makedirs(path, exist_ok=True)
        if fresh:
            # a writer owns its dataset dir: stale cycles from a previous
            # run would silently mix into training via load_dataset's glob
            for name in os.listdir(path):
                if ((name.startswith("cycle_") and name.endswith(".npz"))
                        or name == "manifest.jsonl"):
                    os.unlink(os.path.join(path, name))

    def write(self, example: Dict) -> bool:
        if self.written >= self.max_cycles:
            self.dropped += 1
            return False
        out = {k: np.asarray(example[k]) for k in _ARRAY_KEYS
               if k in example}
        for k, v in example.items():
            if k.startswith("plan_") and v is not None:
                out[k] = np.asarray(v, np.int32)
        out["score_cols"] = np.asarray(int(example["score_cols"]))
        out["winner"] = np.asarray(str(example.get("winner", "greedy")))
        fname = f"cycle_{self.written:05d}.npz"
        fp = os.path.join(self.path, fname)
        with open(fp + ".tmp", "wb") as f:
            np.savez_compressed(f, **out)
        os.replace(fp + ".tmp", fp)
        with open(os.path.join(self.path, "manifest.jsonl"), "a") as f:
            f.write(json.dumps({
                "file": fname, "winner": str(out["winner"]),
                "pods": int(out["req"].shape[0]),
                "nodes": int(out["free0"].shape[0]),
                "plans": sorted(k for k in out if k.startswith("plan_")),
            }) + "\n")
        self.written += 1
        return True

    __call__ = write


def load_dataset(path: str) -> List[Dict]:
    """Read every cycle npz under `path` (sorted, deterministic)."""
    out = []
    for name in sorted(os.listdir(path)):
        if not (name.startswith("cycle_") and name.endswith(".npz")):
            continue
        with np.load(os.path.join(path, name)) as z:
            ex = {k: np.asarray(z[k]) for k in z.files}
        ex["score_cols"] = int(ex["score_cols"])
        ex["winner"] = str(ex["winner"])
        out.append(ex)
    return out


# ------------------------------------------------------------------ trainer
def _prepare(ex: Dict, device) -> Optional[Dict[str, torch.Tensor]]:
    """Derive the fixed-shape training tensors for one recorded cycle on
    `device`: the [N, M] fit mask and targets exactly (int32 arithmetic as
    the host builds it), the feature rows with policy/features, the
    normalized request/free columns in float64 rounded to float32."""
    device = torch.device(device)
    sc = int(ex["score_cols"])
    req = np.asarray(ex["req"], np.int32)
    free0 = np.asarray(ex["free0"], np.int32)
    n, r = req.shape
    m = free0.shape[0]
    sc = min(max(sc, 1), r)
    winner = ex.get("winner", "greedy")
    target = ex.get(f"plan_{winner}", ex.get("plan_greedy"))
    if target is None or n == 0 or m == 0:
        return None

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(
            a if dtype is None else np.asarray(a, dtype))).to(device)

    # plans are recorded over the LIVE asks ([:num_pods]) while the solve
    # tensors keep their bucket padding — pad with -1 (padded rows are
    # valid=False and masked out of every loss)
    target = np.asarray(target, np.int32)
    if target.shape[0] < n:
        target = np.concatenate(
            [target, np.full(n - target.shape[0], -1, np.int32)])
    target_t = dev(target[:n])
    req_t = dev(req)
    free_t = dev(free0)
    cap_t = dev(ex["cap"], np.int32)
    valid_t = dev(ex["valid"], bool)
    node_ok_t = dev(ex["node_ok"], bool)
    # fit feasibility over ALL recorded columns (ports ride synthetic
    # columns in req/free0 when present); one [N, M] temporary a column
    ok = valid_t[:, None] & node_ok_t[None, :]
    for col in range(r):
        ok &= (free_t[None, :, col] - req_t[:, None, col]) >= 0
    inv = pf.inv_capacity_scale(cap_t[:, :sc])
    pod_f = pf.pod_features(req_t[:, :sc], inv)
    node_f = pf.node_features(free_t[:, :sc], cap_t[:, :sc], inv)
    inv64 = inv.double()
    q = req_t[:, :sc].double() * inv64[None, :]
    return {
        "pod_f": pod_f.float(),
        "node_f": node_f.float(),
        "ok": ok,
        "target": target_t,
        "tmask": valid_t & (target_t >= 0),
        "valid_rows": valid_t.float(),
        "vunits": q.sum(dim=1).float(),
        "req_n": q.float(),
        "free_n": (free_t[:, :sc].clamp(min=0).double()
                   * inv64[None, :]).float(),
        # contention proxy: how busy the node already is
        "cont": 1.0 - node_f[:, pf.FEAT_COLS].float(),
    }


def _leaves(params: Dict) -> List[torch.Tensor]:
    """The trainable leaves of device-form params, in the JAX pytree's
    flatten order (tau is not trained: no loss reads it)."""
    return [x for layers in (params["node"], params["pod"])
            for wb in layers for x in wb]


@torch.no_grad()
def _adam_step(leaves, grads, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step in place: the JAX package's formula in its order,
    float32 throughout (Python scalars act in float32)."""
    for p, g, mi, vi in zip(leaves, grads, m, v):
        mi.copy_(b1 * mi + (1 - b1) * g)
        vi.copy_(b2 * vi + (1 - b2) * g * g)
        mhat = mi / (1 - b1 ** t)
        vhat = vi / (1 - b2 ** t)
        p.copy_(p - lr * mhat / (torch.sqrt(vhat) + eps))


def im_loss(params, pod_f, node_f, ok, target, tmask):
    """Imitation: masked cross-entropy against the duel winner's node."""
    ls = pnet.score_matrix(params, pod_f, node_f)
    logits = torch.where(ok, ls, _MASK)
    lse = torch.logsumexp(logits, dim=1)
    m = logits.shape[1]
    cols = torch.arange(m, device=logits.device)
    onehot = cols[None, :] == target.clamp(0, m - 1)[:, None]
    tgt = torch.where(onehot, logits, 0.0).sum(dim=1)
    ce = torch.where(tmask, lse - tgt, 0.0)
    return ce.sum() / tmask.sum().clamp(min=1)


def ft_loss(params, pod_f, node_f, ok, vunits, req_n, free_n, cont,
            valid_rows, *, beta, overload_w, contention_w):
    """Fine-tune: the negated relaxed packing objective per valid ask."""
    ls = pnet.score_matrix(params, pod_f, node_f)
    n, m = ls.shape
    logits = torch.where(ok, beta * ls, _MASK)
    aug = torch.cat([logits, torch.zeros((n, 1), dtype=torch.float32,
                                         device=ls.device)], dim=1)
    p = torch.softmax(aug, dim=1)[:, :m]
    p = torch.where(ok, p, 0.0) * valid_rows[:, None]
    placed = p.sum(dim=1)
    units = (vunits * placed).sum()
    load = p.T @ req_n                                        # [M, sc]
    over = (load - free_n).clamp(min=0.0).sum()
    # contention is a per-pod DISCOUNT on the units earned on busy nodes
    contention = ((vunits[:, None] * p) * cont[None, :]).sum()
    n_eff = valid_rows.sum().clamp(min=1.0)
    return -(units - overload_w * over - contention_w * contention) / n_eff


@contextlib.contextmanager
def _full_f32_matmul():
    """Matrix products in full float32 for the fit, whatever the caller
    set (TF32 would round the products' inputs to 10 mantissa bits)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def fit(examples: List[Dict], *, seed: int = 0, imitation_epochs: int = 80,
        finetune_epochs: int = 60, lr: float = 5e-3, beta: float = 4.0,
        overload_w: float = 2.0, contention_w: float = 0.05,
        device=None, step_times: Optional[Dict[str, list]] = None,
        ) -> Tuple[Dict, Dict]:
    """Train a scorer from recorded duel cycles on `device` (default
    `cuda`, raising without a card). Returns (host-form params, report).
    Deterministic in (examples, seed, hyperparameters, device).
    step_times, when given, receives each step's wall seconds (the step
    synchronized by its loss read) under "imitation" and "finetune"."""
    device = resolve_device(device)
    preps = [p for p in (_prepare(ex, device) for ex in examples)
             if p is not None]
    if not preps:
        raise ValueError("dataset contains no trainable cycles")
    params = pnet.params_from_numpy(pnet.init_params(seed), device)
    leaves = _leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    m_s = [torch.zeros_like(x) for x in leaves]
    v_s = [torch.zeros_like(x) for x in leaves]
    t = 0
    report = {"examples": len(preps), "imitation": [], "finetune": []}
    phases = (
        ("imitation", imitation_epochs, lr,
         lambda p: im_loss(params, p["pod_f"], p["node_f"], p["ok"],
                           p["target"], p["tmask"])),
        ("finetune", finetune_epochs, lr * 0.5,
         lambda p: ft_loss(params, p["pod_f"], p["node_f"], p["ok"],
                           p["vunits"], p["req_n"], p["free_n"], p["cont"],
                           p["valid_rows"], beta=beta, overload_w=overload_w,
                           contention_w=contention_w)),
    )
    with _full_f32_matmul():
        for name, epochs, step_lr, loss_fn in phases:
            for epoch in range(epochs):
                tot = 0.0
                for p in preps:
                    t0 = time.perf_counter()
                    t += 1
                    loss = loss_fn(p)
                    grads = torch.autograd.grad(loss, leaves)
                    _adam_step(leaves, grads, m_s, v_s, t, step_lr)
                    tot += float(loss.detach())
                    if step_times is not None:
                        step_times.setdefault(name, []).append(
                            time.perf_counter() - t0)
                if epoch in (0, epochs - 1) or epoch % 20 == 0:
                    report[name].append(round(tot / len(preps), 5))
    return pnet.params_to_numpy(params), report
