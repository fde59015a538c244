"""Feature rows of the learned scorer over the solver's arguments.

The feature tensors are fixed-width whatever the fleet's resource-vocab
width R: per-pod rows are [N, F_POD] and per-node rows [M, F_NODE], the
first FEAT_COLS resource columns carried verbatim (zero-padded when the
vocab is narrower) and the rest summarized as scale-free aggregates. Every
value is normalized, per column by the fleet's mean node capacity (the
scale the pack LP prices with) or per node by the node's own capacity, so
a checkpoint trained at one fleet scale transfers to another.

FEATURE_VERSION is part of the checkpoint manifest: a checkpoint trained
against another feature schema is rejected at load (net.load_checkpoint).

The arithmetic is the JAX package's functions' op by op: sums over the
resource columns run left to right in float32, a mean is the sum times the
count's float32 reciprocal (jnp.mean's form) and the other divisions by a
count are divisions. Inside a jitted solve XLA also fuses the products into
the sums and turns those divisions into products, so there its features
may differ from these in the last bit.
"""
from __future__ import annotations

import torch

# bump when the shape or meaning of any feature column changes: the
# checkpoint loader rejects manifests built against another version
FEATURE_VERSION = 1

# resource columns carried verbatim (zero-padded)
FEAT_COLS = 4

F_POD = 8
F_NODE = 8


def _col_sum(x: torch.Tensor) -> torch.Tensor:
    """[*, R] -> [*]: float32 sum of the columns, left to right (0 when R
    is 0)."""
    total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for r in range(x.shape[-1]):
        total = total + x[..., r]
    return total


def _recip(n: int) -> float:
    """1 / max(n, 1): the reciprocal a mean multiplies by, in float32."""
    return 1.0 / float(max(n, 1))


def inv_capacity_scale(cap_i: torch.Tensor) -> torch.Tensor:
    """[R] per-column normalization: 1 / the mean node capacity (at least
    1), the scale the pack LP and the duel's packed units use."""
    mean = cap_i.float().sum(dim=0) * _recip(cap_i.shape[0])
    return 1.0 / mean.clamp(min=1.0)


def _first_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """[*, R] -> [*, width]: the leading columns verbatim, zero-padded."""
    r = x.shape[1]
    if r >= width:
        return x[:, :width]
    pad = torch.zeros((x.shape[0], width - r), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=1)


def pod_features(req_i: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """[N, F_POD] per-ask features from the integer request rows over the
    scoring columns (req_i [N, R], inv_scale [R]). Columns:
      0..3  normalized request, the first FEAT_COLS columns verbatim
      4     total normalized request
      5     max normalized column (the bottleneck resource)
      6     dominant share: max / total
      7     breadth: the share of scoring columns the ask requests
    """
    q = req_i.float() * inv_scale[None, :]                       # [N, R]
    total = _col_sum(q)
    mx = q.amax(dim=1) if q.shape[1] else torch.zeros_like(total)
    dom = mx / total.clamp(min=1e-9)
    breadth = _col_sum((q > 0).float()) / float(max(q.shape[1], 1))
    return torch.cat([_first_cols(q, FEAT_COLS), total[:, None],
                      mx[:, None], dom[:, None], breadth[:, None]], dim=1)


def node_features(free_i: torch.Tensor, cap_i: torch.Tensor,
                  inv_scale: torch.Tensor) -> torch.Tensor:
    """[M, F_NODE] per-node features from the current free capacity
    (free_i, cap_i [M, R] integer over the scoring columns); the round loop
    recomputes them as placements land. The verbatim columns are
    fleet-normalized absolute free, so two empty nodes of opposite shape
    differ. Columns:
      0..3  fleet-normalized free, the first FEAT_COLS columns verbatim
      4     mean free fraction of own capacity
      5     min free fraction (the node's bottleneck)
      6     max free fraction
      7     mean fleet-normalized free over the scoring columns
    """
    cap = cap_i.float().clamp(min=1.0)
    pos = free_i.float().clamp(min=0.0)
    q = pos * inv_scale[None, :]                                 # [M, R]
    f = pos / cap                                                # [M, R]
    mean_f = _col_sum(f) * _recip(f.shape[1])
    if f.shape[1]:
        min_f, max_f = f.amin(dim=1), f.amax(dim=1)
    else:
        min_f = max_f = torch.zeros_like(mean_f)
    total = _col_sum(q) / float(max(free_i.shape[1], 1))
    return torch.cat([_first_cols(q, FEAT_COLS), mean_f[:, None],
                      min_f[:, None], max_f[:, None], total[:, None]], dim=1)
