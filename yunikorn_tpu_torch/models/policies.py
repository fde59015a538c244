"""Node scoring policies (the JAX package's models/policies.py in PyTorch).

Policies:
  binpacking — prefer nodes with the least normalized free capacity
  spread     — prefer nodes with the most normalized free capacity
  align      — binpacking plus a request/free alignment dot-product, so pods
               go to nodes whose free-resource *shape* matches the request

The float arithmetic is written out in the order and roundings XLA uses on
the CPU, so that argmax ties fall the same way: a mean over R is the
left-to-right sum times float32(1/R); `1 - mean` is one fused multiply-add;
a norm or a dot product over R is a left-to-right chain of fused multiply-adds.
torch has no fused multiply-add on tensors, so `fma_f32` computes one exactly
in float64. The same code runs on the card, so the CPU and CUDA paths agree
bit for bit.

That is XLA's order at R = 8, the resource width the snapshot encoder builds
for up to eight resource types, with the power-of-two node counts the encoder
pads to. XLA vectorizes other shapes differently (at R = 4, 16 and 32 some
alignment scores, at R = 32 the means, and at 200 nodes the dot products
differ from this order in the last bit); the port keeps one fixed order.
"""
from __future__ import annotations

import torch

POLICIES = ("binpacking", "spread", "align")


def fma_f32(a, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding (broadcasting float32 tensors).

    The product is exact in float64; the float64 sum is rounded to odd (its
    exact error from TwoSum decides), and a round-to-odd result in 53 bits
    rounds to the correctly rounded 24-bit result."""
    p = a.double() * b.double()
    # a constant is filled on the device: torch.tensor would copy it from
    # the host and synchronise
    cd = c.double() if isinstance(c, torch.Tensor) else torch.full(
        (), float(c), dtype=torch.float64, device=p.device)
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf))
    return torch.where((err != 0) & even, toward, s).float()


def _fma_chain(x, y) -> torch.Tensor:
    """Left-to-right sum over the last axis of x * y, one fused multiply-add
    per term."""
    acc = x[..., 0] * y[..., 0]
    for r in range(1, x.shape[-1]):
        acc = fma_f32(x[..., r], y[..., r], acc)
    return acc


def node_base_scores(free_i32, capacity_i32, policy: str) -> torch.Tensor:
    """Per-node score [M] shared by all pods; higher is better."""
    free = free_i32.to(torch.float32)
    cap = torch.clamp(capacity_i32.to(torch.float32), min=1.0)
    ratio = free / cap
    total = ratio[:, 0]
    for r in range(1, ratio.shape[1]):
        total = total + ratio[:, r]
    inv_r = torch.full((), 1.0 / ratio.shape[1], dtype=torch.float32,
                       device=free.device)
    if policy == "spread":
        # mean normalized free capacity in [0, 1]
        return total * inv_r
    # binpacking and align share the packed base, 1 - mean
    return fma_f32(-total, inv_r, 1.0)


def alignment_scores(req_chunk_i32, free_i32, capacity_i32) -> torch.Tensor:
    """[C, M] request/free shape-alignment bonus: the normalized dot product
    of each request with each node's normalized free vector, scaled small so
    the packing base dominates and alignment breaks ties."""
    cap = torch.clamp(capacity_i32.to(torch.float32), min=1.0)
    free_n = free_i32.to(torch.float32) / cap                         # [M, R]
    req = req_chunk_i32.to(torch.float32)                             # [C, R]
    norm = torch.sqrt(_fma_chain(req, req))[:, None]
    req_n = req / torch.clamp(norm, min=1e-6)
    return 0.125 * _fma_chain(req_n[:, None, :], free_n[None, :, :])
