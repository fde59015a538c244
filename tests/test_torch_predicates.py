"""The port's predicates and scoring policies against the JAX package's on
the same numpy-seeded inputs: bit-equal, bitsets with bit 31 set included."""
import jax
import numpy as np
import pytest
import torch

from yunikorn_tpu.models import policies as jpol
from yunikorn_tpu.ops import predicates as jpred
from yunikorn_tpu_torch.models import policies as tpol
from yunikorn_tpu_torch.ops import predicates as tpred


def sparse_bits(rng, shape, density):
    """uint32 words with about `density` of their bits set, bit 31 often."""
    bits = rng.random(shape + (32,)) < density
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    return (bits * weights).sum(-1).astype(np.uint32)


def group_inputs(seed, G=6, T=3, E=2, W=3, Wt=2, Wp=2, M=96, P=4):
    rng = np.random.default_rng(seed)
    labels = sparse_bits(rng, (M, W), 0.5)
    # requirements drawn from real node label words, so some terms match
    term_req = labels[rng.integers(0, M, (G, T))] & sparse_bits(rng, (G, T, W), 0.08)
    term_forb = sparse_bits(rng, (G, T, W), 0.03)
    anyof = sparse_bits(rng, (G, T, E, W), 0.1)
    pref_req = labels[rng.integers(0, M, (G, P))] & sparse_bits(rng, (G, P, W), 0.1)
    return dict(
        g_term_req=term_req, g_term_forb=term_forb,
        g_term_valid=rng.random((G, T)) < 0.8,
        g_anyof=anyof, g_anyof_valid=rng.random((G, T, E)) < 0.5,
        g_tol=sparse_bits(rng, (G, Wt), 0.5),
        g_ports=sparse_bits(rng, (G, Wp), 0.02),
        g_pref_req=pref_req, g_pref_forb=sparse_bits(rng, (G, P, W), 0.05),
        g_pref_weight=rng.integers(0, 101, (G, P)).astype(np.float32),
        node_labels=labels,
        node_taints=sparse_bits(rng, (M, Wt), 0.03),
        node_taints_soft=sparse_bits(rng, (M, Wt), 0.1),
        node_ports=sparse_bits(rng, (M, Wp), 0.05),
        node_ok=rng.random((M,)) < 0.9,
    )


def to_torch(a):
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def run_both(jfn, tfn, inp, names):
    want = np.asarray(jax.jit(jfn)(*[inp[n] for n in names]))
    got = tfn(*[to_torch(inp[n]) for n in names]).numpy()
    return want, got


SCREEN = ("g_term_req", "g_term_forb", "g_term_valid", "g_anyof",
          "g_anyof_valid", "g_tol", "node_labels", "node_taints", "node_ok")
FEAS = ("g_term_req", "g_term_forb", "g_term_valid", "g_anyof",
        "g_anyof_valid", "g_tol", "g_ports", "node_labels", "node_taints",
        "node_ports", "node_ok")
BONUS = ("g_pref_req", "g_pref_forb", "g_pref_weight", "node_labels")
PENALTY = ("g_tol", "node_taints_soft")


@pytest.mark.parametrize("fn,names", [
    ("group_screen", SCREEN), ("group_feasibility", FEAS),
    ("group_preferred_bonus", BONUS), ("group_soft_penalty", PENALTY)])
@pytest.mark.parametrize("seed", [0, 1])
def test_predicate_bit_equal(fn, names, seed):
    inp = group_inputs(seed)
    want, got = run_both(getattr(jpred, fn), getattr(tpred, fn), inp, names)
    assert want.dtype == got.dtype
    if want.dtype == np.float32:
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    else:
        np.testing.assert_array_equal(want, got)
    if fn == "group_feasibility":
        assert 0 < want.sum() < want.size          # both outcomes occur


def test_popcount_high_bit():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0xF0F0F0F0, 0x7FFFFFFF,
                      0x80000001], np.uint32)
    got = tpred.popcount32(to_torch(words)).numpy()
    np.testing.assert_array_equal(got, [bin(int(w)).count("1") for w in words])


@pytest.mark.parametrize("policy", ["binpacking", "spread", "align"])
def test_node_base_scores_bit_equal(policy):
    rng = np.random.default_rng(7)
    M, R = 300, 8
    free = rng.integers(-50, 5000, (M, R)).astype(np.int32)
    cap = np.maximum(free, 0) + rng.integers(0, 5000, (M, R)).astype(np.int32)
    want = np.asarray(jax.jit(lambda f, c: jpol.node_base_scores(f, c, policy))(
        free, cap))
    got = tpol.node_base_scores(to_torch(free), to_torch(cap), policy).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_alignment_scores_bit_equal():
    rng = np.random.default_rng(8)
    M, C, R = 256, 64, 8     # node rows are padded to a power of two
    free = rng.integers(0, 300000, (M, R)).astype(np.int32)
    cap = free + rng.integers(1, 300000, (M, R)).astype(np.int32)
    req = rng.integers(0, 300000, (C, R)).astype(np.int32)
    want = np.asarray(jax.jit(jpol.alignment_scores)(req, free, cap))
    got = tpol.alignment_scores(to_torch(req), to_torch(free),
                                to_torch(cap)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_fma_f32_single_rounding():
    """fma_f32 equals the exactly rounded a * b + c (checked with Python
    fractions), including cases where a float64 sum alone double-rounds."""
    from fractions import Fraction

    rng = np.random.default_rng(9)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 1e-3).astype(np.float32)
    # a product whose exact sum with c lies just off a float32 midpoint
    a[0], b[0], c[0] = np.float32(1 + 2**-23), np.float32(1 + 2**-23), np.float32(2**-24)
    got = tpol.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    for i in range(a.shape[0]):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.array(v).view(np.int32)) & 1))
        assert got[i] == best, i
