"""Node-dimension sharding of the solve over a device mesh (the JAX package's
parallel/mesh.py in PyTorch).

The pods x nodes feasibility and scoring problem shards over the NODE
dimension:

  node-side tensors [M, ...]  cut along M: shard i holds rows lo_i..hi_i
                              on its own device
  group state       [G, M]    cut along M the same way
  pod-side tensors  [N, ...]  one copy on the lead device (one row per pod)

One process drives every shard, as the JAX core drives its mesh from one
program. What is node-local runs on each shard's device: the group
feasibility and soft rows, the base scores, the locality rules, the
odd rounds' best-node kernel on the shard's slice and the scatter of the
accepted requests into the shard's free capacity; under the learned
policy the node embedding and the learned_propose kernel's shard part; in
the cvx arm the [N, M / k] relaxation state and its rounding's draws. The
stages that order nodes globally (the water fill's score sort, the
topology gang fill, the accept scans, the learned proposal's finish) read
the node rows gathered onto the lead device, as GSPMD gathers for them.
The cross-shard steps are the few NodeMesh methods below: each is a
`Tensor.to(lead, non_blocking=True)` copy followed by a concatenation, a
max or a sum. Between two cards that copy is a peer copy; on one device
(set_mesh_devices([cuda:0] * 4), [cpu] * 8) it is a view.

Every result is bit-identical to the single-device solve: the node-local
stages are elementwise along M, the best-node and learned keys merge by a
max that is the same in any shard order (ops/best_nodes.merge_keys,
ops/learned.merge_proposals), integer scatters are exact in any order, the
node tower runs in fleet-aligned row blocks (ops/learned.embed_nodes), and
every float sum and product of the cvx arm runs in blocks whose width the
layout does not change (ops/cvx_solve.node_blocks): each shard sums its
128-column blocks of a row on its device and the lead device sums the
gathered partials (row_total), the same ops on the same values as on one
device when the mesh has 2, 4 or 8 shards and 8 divides M.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

# which arms run under a mesh, as the JAX package names them (all do)
# the pack arm under a mesh: the mesh-aligned "topo" partitioner cuts every
# part inside one shard (pack_solve_sharded)
PACK_SHARDED_SUPPORTED = True
# the learned arm: solve_sharded(learned=), each shard embedding its nodes
# and hashing its own pairs (learned_propose's node offset)
LEARNED_SHARDED_SUPPORTED = True
# the cvx arm: cvx_solve_sharded, the [N, M] relaxation cut along M
CVX_SHARDED_SUPPORTED = True

class Shards(tuple):
    """One tensor cut along its node axis `dim` into a mesh's shards: the
    pieces in shard order, each on its shard's device."""

    def __new__(cls, parts, dim: int = 0):
        self = super().__new__(cls, parts)
        self.dim = dim
        return self

    @property
    def shape(self) -> tuple:
        """The whole tensor's shape."""
        shape = list(self[0].shape)
        shape[self.dim] = sum(p.shape[self.dim] for p in self)
        return tuple(shape)


def one_piece(x):
    """Shards of one piece as that piece (a mesh of one holds whole
    tensors); anything else as it is."""
    return x[0] if isinstance(x, Shards) and len(x) == 1 else x


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(x))
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x


class NodeMesh:
    """The devices of a 1-D node mesh, the lead device (devices[0], where
    the pod-side stages run) and the cross-shard steps. A device may
    repeat: several shards on one card are real launches, one a shard."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.size = len(self.devices)
        self.lead = self.devices[0]

    def __repr__(self) -> str:
        return f"NodeMesh({[str(d) for d in self.devices]})"

    def bounds(self, M: int) -> list:
        """Each shard's node rows [lo, hi): M // size each."""
        if M % self.size:
            raise ValueError(f"node capacity {M} not divisible by mesh size "
                             f"{self.size}")
        m = M // self.size
        return [(i * m, (i + 1) * m) for i in range(self.size)]

    def split(self, x, dim: int = 0) -> Optional[Shards]:
        """x (a numpy array or a tensor; uint32 bitsets become int32 views)
        cut along dim into contiguous pieces on the shards' devices. Shards
        and None pass through (made contiguous)."""
        if x is None:
            return x
        if isinstance(x, Shards):
            return Shards([p.contiguous() for p in x], x.dim)
        x = _as_tensor(x)
        if self.size == 1:
            return Shards((x.to(self.lead).contiguous(),), dim)
        return Shards([x.narrow(dim, lo, hi - lo).to(d, non_blocking=True)
                       .contiguous()
                       for d, (lo, hi) in zip(self.devices,
                                              self.bounds(x.shape[dim]))],
                      dim)

    def put(self, x, i: int):
        """x (pod-side, on the lead device) on shard i's device."""
        return None if x is None else x.to(self.devices[i],
                                            non_blocking=True)

    def gather(self, parts, dim: Optional[int] = None) -> torch.Tensor:
        """The pieces concatenated on the lead device (the one piece itself
        on a mesh of one; a whole tensor as it is). dim defaults to the
        Shards' own."""
        if isinstance(parts, torch.Tensor):
            return parts
        if dim is None:
            dim = getattr(parts, "dim", 0)
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.lead, non_blocking=True) for p in parts],
                         dim)

    def to_lead(self, parts) -> list:
        return [p.to(self.lead, non_blocking=True) for p in parts]

    def sum(self, parts) -> torch.Tensor:
        """The pieces summed on the lead device, in shard order."""
        parts = self.to_lead(parts)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out


def make_mesh(devices=None) -> NodeMesh:
    """A node mesh over `devices` (default utils/torchtools.mesh_devices():
    the cards, or set_mesh_devices' list)."""
    if devices is None:
        from yunikorn_tpu_torch.utils.torchtools import mesh_devices

        devices = mesh_devices()
    return NodeMesh(devices)


def solve_sharded(batch, node_arrays, mesh: NodeMesh, *,
                  max_rounds: int = 16, chunk: int = 512,
                  policy: str = "binpacking", free_delta=None,
                  node_mask=None, ports_delta=None, max_batch: int = 65536,
                  device_state=None, learned=None):
    """ops/assign.solve_batch with the node axis sharded over `mesh`: the
    same arguments (less use_pallas: the mesh runs the exact mode, as the
    reference's mesh runs its plain argmax), the same SolveResult, tensors
    on the lead device. Batches above max_batch (rounded down to a power of
    two) run as chained rank-ordered slices over the same shards.

    M must be divisible by the mesh size (node capacities are powers of
    two, meshes are 2^k devices). Arg assembly is the single-device path's
    prepare_solve_args, so the core routes here without semantic drift.
    device_state: the encoder's mirror over this mesh
    (SnapshotEncoder.device_arrays(mesh=mesh)): its Shards stay on their
    devices, so node state moves once per change, not once per cycle.
    learned = (params, seed) runs the learned policy's solve (the params
    ride to every shard; each embeds its own nodes). The result's
    replicated_bytes is the host bytes of the pod-side args shipped to the
    lead device (the node side rides the mirror, which counts its own
    uploads)."""
    from yunikorn_tpu_torch.ops import assign

    mesh.bounds(node_arrays.capacity)   # raises unless M % size == 0
    np_args, static = assign.prepare_solve_args(
        batch, node_arrays, free_delta=free_delta, node_mask=node_mask,
        ports_delta=ports_delta, device_state=device_state,
        # the pod args ship from the host to the lead device; the row
        # store's gather is a single-device tensor the mesh path skips
        allow_req_device=False)
    kwargs = dict(static, max_rounds=max_rounds, chunk=chunk, policy=policy,
                  use_pallas=False, mesh=mesh, learned=learned)
    N = np_args[0].shape[0]
    mb = 1 << (max(int(max_batch), 64).bit_length() - 1)
    if N > mb:
        np_args_s, order = assign._sort_pods_by_rank(np_args)
        assigned, around, free_after, rounds, cnt = assign.solve_chunked(
            *np_args_s, chunk_pods=mb, **kwargs)
        if order is not None:
            assigned, around = assign._unsort(order, assigned, around)
    else:
        assigned, around, free_after, rounds, cnt = assign.solve(
            *np_args, **kwargs)
    return assign.SolveResult(
        assigned=assigned, free_after=free_after, rounds=rounds,
        accept_round=around,
        cnt_final=cnt if batch.locality is not None else None,
        # the pod-side args (the first 14 of SOLVE_ARG_NAMES)
        replicated_bytes=sum(a.nbytes for a in np_args[:14]
                             if isinstance(a, np.ndarray)))


def usage_fold_sharded(usage, mesh: NodeMesh) -> torch.Tensor:
    """The cross-shard fold of the ledger's usage mirror: the [S, T, K]
    int64 confirmed usage (Shards cut along S, or one tensor to cut) summed
    on each piece's device, then the partial [T, K] totals summed on the
    lead device (ops/gate_solve.usage_fold's totals: integer sums are the
    same in any order). S must be divisible by the mesh size."""
    from yunikorn_tpu_torch.ops.gate_solve import usage_fold

    return mesh.sum([usage_fold(p) for p in mesh.split(usage)])


def pack_solve_sharded(batch, node_arrays, mesh: NodeMesh, *,
                       policy: str = "binpacking", free_delta=None,
                       node_mask=None, ports_delta=None, seed: int = 0,
                       chunk: int = 512, device_state=None):
    """ops/pack_solve's solve with the node axis sharded over `mesh`: the
    partitioner forced to the mesh-aligned "topo" mode (`pick_parts(...,
    n_shards=mesh size)` floors the part count at the shard count and the
    (shard, ICI domain, row) node order cuts every part inside one shard),
    each shard's parts relaxed and rounded on its device, the repair on the
    sharded round loop. Bit-equal to the single-device
    pack_solve(partitioner="topo", n_shards=mesh size) on the same args.
    Raises PackUnsupported for batches outside the arm's model and shapes
    that do not split into whole parts per shard."""
    from yunikorn_tpu_torch.ops import assign
    from yunikorn_tpu_torch.ops import pack_solve as pack_mod

    pack_mod._unsupported_batch(batch, pack_mod.PackUnsupported)
    np_args, static = assign.prepare_solve_args(
        batch, node_arrays, free_delta=free_delta, node_mask=node_mask,
        ports_delta=ports_delta, device_state=device_state,
        allow_req_device=False)
    N = np_args[assign.SOLVE_ARG_NAMES.index("req")].shape[0]
    M = np_args[assign.SOLVE_ARG_NAMES.index("free")].shape[0]
    if not pack_mod.shape_supported(N, M, n_shards=mesh.size):
        raise pack_mod.PackUnsupported(
            f"shape ({N} pods, {M} nodes) does not split into whole parts "
            f"per shard over {mesh.size} devices")
    n_parts = pack_mod.pick_parts(N, M, n_shards=mesh.size)
    assigned, free_after, feasible = pack_mod.pack_solve(
        *np_args, seed, n_parts=n_parts, partitioner="topo",
        n_shards=mesh.size, chunk=chunk, policy=policy,
        score_cols=static["score_cols"], mesh=mesh)
    return pack_mod.PackResult(assigned=assigned, free_after=free_after,
                               feasible=feasible, n_parts=n_parts,
                               partitioner="topo")


def cvx_solve_sharded(batch, node_arrays, mesh: NodeMesh, *,
                      policy: str = "binpacking", free_delta=None,
                      node_mask=None, ports_delta=None, seed: int = 0,
                      chunk: int = 512, device_state=None, learned=None):
    """ops/cvx_solve's full-fleet solve with the node axis sharded over
    `mesh`: the [N, M] relaxation state, its feasibility and soft rows, the
    duals and the rounding's noise cut along M on the shards' devices (X
    is never gathered), the row sums over M as fixed trees, the rounding's
    argmax merged across shards and its accept on the lead device, the
    repair on the sharded round loop. The same CvxResult as
    cvx_solve_batch, free_after gathered on the lead device, bit-equal to
    it when M / mesh size is a power of two. learned: the two-tower params
    for the warm-started duals (each shard embeds its own nodes). Raises
    CvxUnsupported for batches outside the model."""
    from yunikorn_tpu_torch.ops import cvx_solve as cvx_mod

    return cvx_mod.cvx_solve_batch(
        batch, node_arrays, policy=policy, free_delta=free_delta,
        node_mask=node_mask, ports_delta=ports_delta, seed=seed, chunk=chunk,
        device_state=device_state, learned=learned, mesh=mesh)


def preempt_solve_sharded(np_args, mesh: NodeMesh, *, max_candidates: int):
    """ops/preempt_solve.preempt_solve with the node axis sharded over
    `mesh`: np_args is prepare_preempt_args' tuple (its node-side tensors
    Shards of the victim mirror over this mesh, or host arrays to cut); the
    ask rows stay on the lead device, the [M, V, R] victim tables on their
    shards, and the per-ask lexicographic argmin merges across shards.
    Plans equal the single device's, victim for victim."""
    from yunikorn_tpu_torch.ops.preempt_solve import preempt_solve

    return preempt_solve(*np_args, max_candidates=max_candidates, mesh=mesh)
