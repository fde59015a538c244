"""Counter-based random numbers for the duel arms: the threefry2x32 stream
of the JAX package's random draws, in PyTorch.

The pack and cvx arms draw their partitions and their rounding noise from
keyed random streams. This module reproduces them: the threefry2x32 hash
(20 rounds, key schedule with the parity constant 0x1BD11BDA), the
partitionable counter layout (a draw of shape S hashes the 64-bit flat
index of each cell, high and low words), and on top of it key creation,
split, fold_in, 32-bit random bits, uniform floats, Gumbel noise and
random permutations.

A key is an int64 tensor of shape [..., 2] holding two unsigned 32-bit
words; every word of the stream lives in int64 masked to 32 bits, so the
same code runs on the CPU and on CUDA. Keys may carry leading batch
dimensions: fold_in and the draws then broadcast, one independent stream
per key.

What is exact and what is not: every integer output (the hash, keys,
bits, permutations) and `uniform` are bit-exact. `gumbel` takes two
logarithms of the uniform draw; torch's `log` may differ from another
library's in the last bit, so Gumbel noise agrees only to about 1e-6 in
absolute value.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    """Rotate each masked 32-bit word of x left by d (in place on x)."""
    t = (x << d).bitwise_and_(MASK)
    return x.bitwise_right_shift_(32 - d).bitwise_or_(t)


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2): int64 tensors of 32-bit words, broadcast together. Returns
    the two output words, each of the broadcast shape."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    shape = torch.broadcast_shapes(k1.shape, k2.shape, x1.shape, x2.shape)
    v0 = (x1 + ks[0]).bitwise_and_(MASK).expand(shape).contiguous()
    v1 = (x2 + ks[1]).bitwise_and_(MASK).expand(shape).contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            v0.add_(v1).bitwise_and_(MASK)
            v1 = _rotl(v1, r).bitwise_xor_(v0)
        v0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        v1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return v0, v1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """The key of an int32 seed: the words (0, seed mod 2^32). Built by
    device fills, which do not synchronise with the host."""
    word = torch.full((), int(seed) & MASK, dtype=torch.int64, device=device)
    return torch.stack([torch.zeros_like(word), word])


def _words(key: torch.Tensor, ndim: int):
    """The key's two words, with ndim trailing unit dimensions for the
    draw's shape."""
    view = key.shape[:-1] + (1,) * ndim
    return key[..., 0].reshape(view), key[..., 1].reshape(view)


def _counters(shape, device, cols=None):
    """The partitionable counters of a draw of `shape`: the high and low
    words of each cell's flat row-major index; with cols = (lo, hi), those
    of the columns lo..hi of the last axis only (row * shape[-1] + lo + j,
    the counters the whole draw gives those cells)."""
    if cols is None:
        n = math.prod(shape)
        idx = torch.arange(n, dtype=torch.int64, device=device).view(shape)
    else:
        lo, hi = (int(c) for c in cols)
        if not 0 <= lo <= hi <= shape[-1]:
            raise ValueError(f"columns {lo}..{hi} lie outside a last axis "
                             f"of {shape[-1]}")
        rows = torch.arange(math.prod(shape[:-1]), dtype=torch.int64,
                            device=device) * shape[-1]
        idx = (rows[:, None] + torch.arange(lo, hi, dtype=torch.int64,
                                            device=device)[None, :])
        idx = idx.view(shape[:-1] + (hi - lo,))
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`num` new keys from one key [2]: [num, 2]."""
    hi, lo = _counters((num,), key.device)
    k1, k2 = _words(key, 1)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """The key [..., 2] folded with the 32-bit integer `data`: the hash of
    the counter pair (0, data)."""
    k1, k2 = key[..., 0], key[..., 1]
    x2 = torch.full((), int(data) & MASK, dtype=torch.int64,
                    device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(x2), x2)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape, cols=None) -> torch.Tensor:
    """32-bit random words of `shape` for each key of key [..., 2]:
    int64 [..., *shape], each word the XOR of the hash's two outputs.
    cols = (lo, hi): only the columns lo..hi of the last axis of that draw
    (a node shard's window), bit for bit the same words."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(shape, key.device, cols)
    k1, k2 = _words(key, len(shape))
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1.bitwise_xor_(b2)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, cols=None) -> torch.Tensor:
    """float32 uniform draws in [minval, maxval): the top 23 bits of each
    random word as the mantissa of a float in [1, 2), minus 1, scaled and
    shifted in float32, and floored at minval. cols as in random_bits."""
    bits = random_bits(key, shape, cols)
    one = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return (floats * span + float(lo)).clamp_(min=float(lo))


def gumbel(key: torch.Tensor, shape, cols=None) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in
    [tiny, 1) (tiny = the smallest normal float32). cols as in
    random_bits."""
    u = uniform(key, shape, _TINY_F32, 1.0, cols)
    return u.log_().neg_().log_().neg_()


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """A random permutation of range(n) (int64 [n]): ceil(3 ln n /
    ln(2^32 - 1)) rounds, each a split of the key and a stable sort of the
    running order by fresh 32-bit words."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.uint32(MASK))))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.argsort(random_bits(sub, (n,)), stable=True)
        x = x[order]
    return x
