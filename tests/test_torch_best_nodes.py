"""The port's best-node computation against the JAX package's two versions:
the plain `exact` mode bit-equal to the XLA argmax `_best_nodes_chunked`, the
plain `quantized` mode bit-equal to the Pallas kernel run in interpret mode.
The CUDA kernel is held against the plain version on the card."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("mode", tbn.MODES)
@pytest.mark.parametrize("has_soft", [True, False])
def test_kernel_matches_plain_on_card(mode, has_soft):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for seed, variant in [(5, "random"), (6, "tie"), (7, "infeasible")]:
        args = torch_args(*problem(seed, variant), device="cuda")
        before = tbn.best_nodes.launches
        got = tbn.best_nodes(*args, mode=mode, has_soft=has_soft)
        torch.cuda.synchronize()
        assert tbn.best_nodes.launches == before + 1
        ref = tbn.best_nodes_reference(*args, mode=mode, has_soft=has_soft)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
