"""The port's best-node computation against the JAX package's two versions:
the plain `exact` mode bit-equal to the XLA argmax `_best_nodes_chunked`, the
plain `quantized` mode bit-equal to the Pallas kernel run in interpret mode,
with and without a mask of requested rows. The CUDA kernel is held against
the plain version on the card in test_torch_best_nodes_card.py, which runs
without JAX."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_kernel import random_problem
from yunikorn_tpu.models.policies import node_base_scores as j_base_scores
from yunikorn_tpu.ops.assign import _best_nodes_chunked as j_best_nodes_chunked
from yunikorn_tpu.ops.pallas_kernels import pallas_best_nodes
from yunikorn_tpu_torch.ops import best_nodes as tbn


def problem(seed, variant):
    """random_problem inputs (N=256, M=512, G=4, R=8) plus base scores and a
    soft matrix; `tie` puts the scores on a coarse grid so that many tie,
    `infeasible` masks every node."""
    rng = np.random.default_rng(seed)
    req, gid, feas, free, cap = random_problem(rng)
    base = np.asarray(j_base_scores(jnp.asarray(free), jnp.asarray(cap),
                                    "binpacking"))
    soft = (rng.random((feas.shape[0], free.shape[0])).astype(np.float32) - 0.5)
    if variant == "tie":
        base = (np.round(base * 4) / 4).astype(np.float32)
        soft = (rng.integers(-1, 2, soft.shape) * 0.25).astype(np.float32)
    if variant == "infeasible":
        feas[:] = False
    return req, gid, feas, soft, free, base


def torch_args(req, gid, feas, soft, free, base, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device)
            for a in (req, gid, feas, soft, free, base)]


@functools.lru_cache(maxsize=None)
def jax_best(seed, variant, mode):
    """The JAX package's answer for every row of problem(seed, variant)."""
    req, gid, feas, soft, free, base = problem(seed, variant)
    if mode == "exact":
        out = jax.jit(lambda *a: j_best_nodes_chunked(
            *a, chunk=128, policy="binpacking"))(
            req, gid, feas, soft, free, free, base)
    else:
        out = pallas_best_nodes(
            jnp.asarray(req), jnp.asarray(gid), jnp.asarray(feas),
            jnp.asarray(soft), jnp.asarray(free), jnp.asarray(base),
            interpret=True, has_soft=True)
    return np.asarray(out[0]), np.asarray(out[1])


def row_mask(kind, n, seed=0):
    if kind == "empty":
        return np.zeros(n, bool)
    if kind == "full":
        return np.ones(n, bool)
    return np.random.default_rng(seed).random(n) < 0.3


@pytest.mark.parametrize("variant", ["random", "tie", "infeasible"])
@pytest.mark.parametrize("seed", [0, 1])
def test_exact_matches_xla_argmax(seed, variant):
    req, gid, feas, soft, free, base = problem(seed, variant)
    want_best, want_feas = jax.jit(
        lambda *a: j_best_nodes_chunked(*a, chunk=128, policy="binpacking"))(
        req, gid, feas, soft, free, free, base)
    best, feasible = tbn.best_nodes(*torch_args(req, gid, feas, soft, free,
                                                base), mode="exact", chunk=128)
    np.testing.assert_array_equal(np.asarray(want_best), best.numpy())
    np.testing.assert_array_equal(np.asarray(want_feas), feasible.numpy())
    if variant == "infeasible":
        assert not feasible.any() and not best.any()


@pytest.mark.parametrize("has_soft", [True, False])
@pytest.mark.parametrize("variant", ["random", "tie", "infeasible"])
def test_quantized_matches_pallas_interpret(variant, has_soft):
    req, gid, feas, soft, free, base = problem(3, variant)
    want_best, want_feas = pallas_best_nodes(
        jnp.asarray(req), jnp.asarray(gid), jnp.asarray(feas),
        jnp.asarray(soft), jnp.asarray(free), jnp.asarray(base),
        interpret=True, has_soft=has_soft)
    best, feasible = tbn.best_nodes(*torch_args(req, gid, feas, soft, free,
                                                base), mode="quantized",
                                    has_soft=has_soft)
    np.testing.assert_array_equal(np.asarray(want_best), best.numpy())
    np.testing.assert_array_equal(np.asarray(want_feas), feasible.numpy())


@pytest.mark.parametrize("mask", ["empty", "full", "random"])
@pytest.mark.parametrize("variant", ["random", "tie", "infeasible"])
@pytest.mark.parametrize("mode", tbn.MODES)
def test_rows_mask_matches_jax_on_requested_rows(mode, variant, mask):
    """Requested rows equal the JAX package's answer; the others are 0 and
    False."""
    args = torch_args(*problem(8, variant))
    want_best, want_feas = jax_best(8, variant, mode)
    rows = row_mask(mask, want_best.shape[0])
    best, feasible = tbn.best_nodes(*args, mode=mode,
                                    rows=torch.from_numpy(rows))
    np.testing.assert_array_equal(np.where(rows, want_best, 0), best.numpy())
    np.testing.assert_array_equal(rows & want_feas, feasible.numpy())
    assert best.dtype == torch.int32 and feasible.dtype == torch.bool
    if variant == "random" and mask != "empty":
        assert feasible.any()


def test_exact_breaks_negative_zero_tie_to_lowest_index():
    """-0.0 and +0.0 tie (argmax compares values): the lower node wins."""
    req = torch.ones((2, 1), dtype=torch.int32)
    gid = torch.zeros((2,), dtype=torch.int32)
    feas = torch.ones((1, 3), dtype=torch.bool)
    soft = torch.zeros((1, 3), dtype=torch.float32)
    free = torch.full((3, 1), 5, dtype=torch.int32)
    base = torch.tensor([-1.0, -0.0, 0.0], dtype=torch.float32)
    best, feasible = tbn.best_nodes(req, gid, feas, soft, free, base)
    assert best.tolist() == [1, 1] and feasible.all()


def test_cpu_tensors_take_the_plain_version():
    req, gid, feas, soft, free, base = problem(4, "random")
    before = tbn.best_nodes.launches
    got = tbn.best_nodes(*torch_args(req, gid, feas, soft, free, base))
    ref = tbn.best_nodes_reference(*torch_args(req, gid, feas, soft, free,
                                               base))
    assert tbn.best_nodes.launches == before
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError):
        tbn.best_nodes(*torch_args(req, gid, feas, soft, free, base),
                       mode="approximate")
