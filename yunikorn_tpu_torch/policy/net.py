"""The two-tower policy scorer and its versioned checkpoint format.

A pod tower and a node tower (small tanh MLPs) meet in a dot product:

    score[i, m] = pod_tower(pod_feats[i]) . node_tower(node_feats[m])

Parameters live in two forms. The host form is the JAX package's pytree
with numpy leaves, {"pod": ((w1, b1), (w2, b2)), "node": (...), "tau":
float32}: `init_params`, the checkpoint IO and `params_hash` work on it,
so a checkpoint written by either package loads in the other with the same
hash. The device form, from `params_from_numpy(params, device)`, holds the
same leaves as float32 tensors on a device and tau as a Python float; the
towers and the solve read it.

Untrained is inert: `init_params` zeroes the pod tower's output layer, so
an untrained net scores exactly 0.0 for every (pod, node) pair and the
learned solve is bit-identical to the greedy one (the proposal gate needs a
strictly positive advantage, the additive term is zero).

Checkpoints are a `.npz` of named leaves plus a JSON manifest carrying the
format version, the feature-schema version, tower dims, a sha256 of the npz
bytes and a content hash of the params. `load_checkpoint` raises
CheckpointError on any mismatch, so a caller keeps its previous policy and
a bad artifact is never half-loaded.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from yunikorn_tpu_torch.policy.features import F_NODE, F_POD, FEATURE_VERSION

CKPT_FORMAT = 1
HIDDEN = 32
EMB = 16

# the learned proposal override's gate: the chosen node's raw learned score
# must beat the mean over the pod's feasible nodes by this margin before
# the policy may override the water-fill proposal (shift-invariant, as the
# training objective is). An untrained net scores 0 everywhere, so the gate
# never fires.
GATE_MARGIN = 0.05


class CheckpointError(RuntimeError):
    """The checkpoint failed validation (corrupt payload, format or feature
    schema mismatch, shape drift). The previous policy must be kept."""


# ---------------------------------------------------------------------- net
def init_params(seed: int = 0, hidden: int = HIDDEN, emb: int = EMB) -> Dict:
    """Host-form params: hidden layers drawn from numpy's RandomState(seed)
    (the JAX package's draw, leaf for leaf); the pod tower's output layer
    exactly zero, so the untrained score matrix is exactly zero."""
    rng = np.random.RandomState(seed)

    def lin(fin, fout, scale):
        return (np.asarray(rng.standard_normal((fin, fout)) * scale,
                           np.float32),
                np.zeros((fout,), np.float32))

    zero_out = (np.zeros((hidden, emb), np.float32),
                np.zeros((emb,), np.float32))
    return {
        "pod": (lin(F_POD, hidden, 1.0 / np.sqrt(F_POD)), zero_out),
        "node": (lin(F_NODE, hidden, 1.0 / np.sqrt(F_NODE)),
                 lin(hidden, emb, 1.0 / np.sqrt(hidden))),
        # Gumbel temperature of the proposal override's exploration
        "tau": np.float32(0.25),
    }


def params_from_numpy(params: Dict, device) -> Dict:
    """Device-form params: the leaves of a host-form pytree (numpy arrays,
    as init_params, load_checkpoint and the JAX package's trainer give
    them, or tensors) as float32 tensors on `device`, tau a Python float.
    Device-form params already on `device` come back unchanged."""
    device = torch.device(device)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32).contiguous()
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x, np.float32))).to(device)

    def tower(layers):
        return tuple((leaf(w), leaf(b)) for w, b in layers)

    return {"pod": tower(params["pod"]), "node": tower(params["node"]),
            "tau": float(np.float32(params["tau"]))}


def params_to_numpy(params: Dict) -> Dict:
    """Host-form params (numpy float32 leaves, tau np.float32) of
    device-form ones: params_from_numpy's inverse, the form the trainer
    returns and save_checkpoint writes."""
    def tower(layers):
        return tuple((w.detach().cpu().numpy().astype(np.float32),
                      b.detach().cpu().numpy().astype(np.float32))
                     for w, b in layers)

    return {"pod": tower(params["pod"]), "node": tower(params["node"]),
            "tau": np.float32(params["tau"])}


def _tower(layers, x):
    (w1, b1), (w2, b2) = layers
    return torch.tanh(x @ w1 + b1) @ w2 + b2


def pod_tower(params: Dict, pod_feats: torch.Tensor) -> torch.Tensor:
    """[N, F_POD] -> [N, E] (device-form params)."""
    return _tower(params["pod"], pod_feats)


def node_tower(params: Dict, node_feats: torch.Tensor) -> torch.Tensor:
    """[M, F_NODE] -> [M, E] (device-form params)."""
    return _tower(params["node"], node_feats)


def score_matrix(params: Dict, pod_feats: torch.Tensor,
                 node_feats: torch.Tensor) -> torch.Tensor:
    """[N, M] learned score (higher = prefer), as one matrix product; the
    solve computes the same pairs chunk by chunk (ops/learned)."""
    return pod_tower(params, pod_feats) @ node_tower(params, node_feats).T


# ------------------------------------------------------------- checkpoint IO
_LEAF_ORDER = ("pod_0_w", "pod_0_b", "pod_1_w", "pod_1_b",
               "node_0_w", "node_0_b", "node_1_w", "node_1_b", "tau")


def _flatten(params: Dict) -> Dict[str, np.ndarray]:
    (pw1, pb1), (pw2, pb2) = params["pod"]
    (nw1, nb1), (nw2, nb2) = params["node"]
    vals = (pw1, pb1, pw2, pb2, nw1, nb1, nw2, nb2, params["tau"])
    out = {}
    for k, v in zip(_LEAF_ORDER, vals):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v, np.float32)
    return out


def _unflatten(leaves: Dict[str, np.ndarray]) -> Dict:
    return {
        "pod": ((leaves["pod_0_w"], leaves["pod_0_b"]),
                (leaves["pod_1_w"], leaves["pod_1_b"])),
        "node": ((leaves["node_0_w"], leaves["node_0_b"]),
                 (leaves["node_1_w"], leaves["node_1_b"])),
        "tau": np.float32(leaves["tau"]),
    }


def params_hash(params: Dict) -> str:
    """Content hash of the params (16 hex chars): the checkpoint's identity
    in the manifest, the cycle entry and the policy_checkpoint_epoch
    gauge."""
    h = hashlib.sha256()
    for k, v in sorted(_flatten(params).items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class PolicyCheckpoint:
    params: Dict          # host form (numpy leaves)
    hash: str
    epoch: int
    manifest: dict
    prefix: str = ""


def save_checkpoint(prefix: str, params: Dict, *, epoch: int = 0,
                    meta: Optional[dict] = None) -> PolicyCheckpoint:
    """Write `<prefix>.npz` + `<prefix>.json` atomically (tmp + replace).
    Returns the checkpoint as the loader would see it."""
    leaves = _flatten(params)
    npz_path, man_path = prefix + ".npz", prefix + ".json"
    d = os.path.dirname(os.path.abspath(npz_path))
    os.makedirs(d, exist_ok=True)
    tmp = npz_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **leaves)
    with open(tmp, "rb") as f:
        npz_sha = hashlib.sha256(f.read()).hexdigest()
    os.replace(tmp, npz_path)
    phash = params_hash(params)
    manifest = {
        "format": CKPT_FORMAT,
        "feature_version": FEATURE_VERSION,
        "f_pod": F_POD,
        "f_node": F_NODE,
        "hidden": int(leaves["pod_0_w"].shape[1]),
        "emb": int(leaves["pod_1_w"].shape[1]),
        "epoch": int(epoch),
        "param_hash": phash,
        "npz_sha256": npz_sha,
        "leaves": {k: [list(v.shape), str(v.dtype)]
                   for k, v in leaves.items()},
        "meta": meta or {},
    }
    tmp = man_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, man_path)
    return PolicyCheckpoint(params=_unflatten(leaves), hash=phash,
                            epoch=int(epoch), manifest=manifest,
                            prefix=prefix)


def load_checkpoint(prefix: str) -> PolicyCheckpoint:
    """Load and validate `<prefix>.npz` / `<prefix>.json`. Any failure
    raises CheckpointError with the reason; nothing is partially applied."""
    npz_path, man_path = prefix + ".npz", prefix + ".json"
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except Exception as e:
        raise CheckpointError(f"manifest unreadable at {man_path}: "
                              f"{type(e).__name__}: {e}")
    if manifest.get("format") != CKPT_FORMAT:
        raise CheckpointError(
            f"checkpoint format {manifest.get('format')!r} != supported "
            f"{CKPT_FORMAT}")
    if manifest.get("feature_version") != FEATURE_VERSION:
        raise CheckpointError(
            f"feature schema v{manifest.get('feature_version')} != the "
            f"extractor's v{FEATURE_VERSION} — retrain against the current "
            "features")
    if (manifest.get("f_pod"), manifest.get("f_node")) != (F_POD, F_NODE):
        raise CheckpointError("feature width mismatch "
                              f"({manifest.get('f_pod')}x"
                              f"{manifest.get('f_node')} != {F_POD}x{F_NODE})")
    try:
        with open(npz_path, "rb") as f:
            raw = f.read()
    except Exception as e:
        raise CheckpointError(f"params unreadable at {npz_path}: "
                              f"{type(e).__name__}: {e}")
    if hashlib.sha256(raw).hexdigest() != manifest.get("npz_sha256"):
        raise CheckpointError("params payload sha256 mismatch (corrupt or "
                              "tampered npz)")
    try:
        with np.load(io.BytesIO(raw)) as z:
            leaves = {k: np.asarray(z[k], np.float32) for k in _LEAF_ORDER}
    except Exception as e:
        raise CheckpointError(f"params npz undecodable: "
                              f"{type(e).__name__}: {e}")
    want = manifest.get("leaves") or {}
    for k, v in leaves.items():
        spec = want.get(k)
        if spec is None or list(v.shape) != list(spec[0]):
            raise CheckpointError(
                f"leaf {k} shape {list(v.shape)} != manifest {spec}")
    if leaves["pod_0_w"].shape != (F_POD, manifest["hidden"]) \
            or leaves["node_0_w"].shape != (F_NODE, manifest["hidden"]) \
            or leaves["pod_1_w"].shape[1] != leaves["node_1_w"].shape[1]:
        raise CheckpointError("tower dims inconsistent with the feature "
                              "schema / embedding width")
    params = _unflatten(leaves)
    phash = params_hash(params)
    if phash != manifest.get("param_hash"):
        raise CheckpointError("param content hash mismatch "
                              f"({phash} != {manifest.get('param_hash')})")
    return PolicyCheckpoint(params=params, hash=phash,
                            epoch=int(manifest.get("epoch", 0)),
                            manifest=manifest, prefix=prefix)
