"""The learned policy's trainer (policy/train, the core's policy_recorder,
cmd/policy_train) against the JAX package's on the same inputs.

- The dataset format crosses packages: a dataset written by either
  package's DatasetWriter loads in the other, arrays equal.
- `_prepare` on scripts/policy_bench.py's 128 x 64 cycles: the fit mask,
  targets and target mask exact, the float fields within 1e-6.
- The two losses and their gradients against jax.value_and_grad of the JAX
  package's losses (captured from its `fit`, jitted as it jits them) on
  one prepared cycle, with a
  non-zero pod output layer: losses within 1e-6 relative, gradients within
  atol 1e-5 + rtol 1e-3 (the node tower's output bias has an exact-zero
  imitation gradient, where both libraries return rounding noise).
- One Adam step on the CPU bit-equal to the JAX `_adam_step`.
- `fit` end to end (30 + 20 epochs on two recorded cycles): imitation
  losses within 1e-4 relative, the last fine-tune loss within 1e-3.
- Both packages' checkpoints through both packages' solves at 192 x 256
  (seed 77): winner learned, placed >= greedy's, in every pairing.
- The port core's policy_recorder on the contended duel trace records
  what the JAX core's records; cmd.policy_train writes a checkpoint the
  JAX loader accepts.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import test_torch_duel
from yunikorn_tpu.ops import assign as jassign
from yunikorn_tpu.ops import pack_solve as jpack
from yunikorn_tpu.policy import net as jnet
from yunikorn_tpu.policy import train as jtrain
from yunikorn_tpu_torch.ops import assign as tassign
from yunikorn_tpu_torch.ops import pack_solve as tpack
from yunikorn_tpu_torch.policy import net as tnet
from yunikorn_tpu_torch.policy import train as ttrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_KEYS = ("pod_f", "node_f", "valid_rows", "vunits", "req_n", "free_n",
              "cont")
EXACT_KEYS = ("ok", "target", "tmask")
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3
FT_KW = dict(beta=4.0, overload_w=2.0, contention_w=0.05)


def policy_bench():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import policy_bench

    return policy_bench


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """policy_bench's --train recording at test scale: two 128 x 64
    greedy-vs-pack duels, written by the JAX package's writer."""
    pb = policy_bench()
    path = str(tmp_path_factory.mktemp("ds"))
    w = jtrain.DatasetWriter(path)
    for s in range(2):
        enc, batch, pr = pb.build(128, 64, seed=s)
        pb.record_cycle(enc, batch, pr, w)
    return path


@pytest.fixture(scope="module")
def fits(dataset):
    """Both packages' fit on the two-cycle dataset, 30 + 20 epochs."""
    exs = jtrain.load_dataset(dataset)
    kw = dict(seed=0, imitation_epochs=30, finetune_epochs=20)
    return jtrain.fit(exs, **kw), ttrain.fit(exs, device="cpu", **kw)


def example(n=4, m=2):
    return {
        "req": np.ones((n, 2), np.int32), "rank": np.arange(float(n)),
        "valid": np.ones(n, bool), "free0": np.full((m, 2), 9, np.int32),
        "cap": np.full((m, 2), 9, np.int32), "node_ok": np.ones(m, bool),
        "priorities": np.zeros(n), "score_cols": 2, "winner": "optimal",
        "plan_greedy": np.array([0, 1, -1, 0], np.int32),
        "plan_optimal": np.array([0, 1, 1, 0], np.int32),
    }


def assert_same_dataset(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert x[k] == y[k], k


@pytest.mark.parametrize("writer, reader", [(jtrain, ttrain),
                                            (ttrain, jtrain)],
                         ids=["jax-to-port", "port-to-jax"])
def test_dataset_crosses_packages(writer, reader, tmp_path):
    """test_dataset_writer_roundtrip_and_cap, written by one package and
    read by both."""
    w = writer.DatasetWriter(str(tmp_path), max_cycles=2)
    ex = example()
    assert w(ex) and w(ex)
    assert not w(ex)                          # capped
    assert w.dropped == 1
    loaded = reader.load_dataset(str(tmp_path))
    assert len(loaded) == 2
    assert loaded[0]["winner"] == "optimal"
    assert loaded[0]["score_cols"] == 2
    np.testing.assert_array_equal(loaded[0]["plan_optimal"],
                                  ex["plan_optimal"])
    assert_same_dataset(loaded, writer.load_dataset(str(tmp_path)))
    with open(tmp_path / "manifest.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["file"] for r in rows] == ["cycle_00000.npz", "cycle_00001.npz"]
    # fresh=True clears the directory it owns
    reader.DatasetWriter(str(tmp_path))
    assert reader.load_dataset(str(tmp_path)) == []


def test_prepare_matches_the_jax_package(dataset):
    for ex in jtrain.load_dataset(dataset):
        want = jtrain._prepare(ex)
        got = ttrain._prepare(ex, "cpu")
        assert sorted(got) == sorted(want)
        for k in EXACT_KEYS:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        for k in FLOAT_KEYS:
            assert got[k].dtype == torch.float32, k
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                       atol=1e-6, err_msg=k)
        assert got["ok"].any() and got["tmask"].any()


def jax_losses():
    """The JAX package's im_loss and ft_loss, as its fit builds them (the
    functions it hands to jax.value_and_grad)."""
    seen = []
    real = jax.value_and_grad

    def spy(fn, *a, **kw):
        seen.append(fn)
        return real(fn, *a, **kw)

    jax.value_and_grad = spy
    try:
        jtrain.fit([example()], imitation_epochs=0, finetune_epochs=0)
    finally:
        jax.value_and_grad = real
    return seen


def trained_like_params(seed=3):
    """init_params with a non-zero pod output layer (an untrained net's
    scores are all zero, which would leave the losses' logits flat)."""
    rng = np.random.RandomState(seed)
    p = jnet.init_params(0)
    (w1, b1), (w2, b2) = p["pod"]
    p["pod"] = ((w1, b1), (rng.standard_normal(w2.shape).astype(np.float32)
                           * 0.3, rng.standard_normal(b2.shape)
                           .astype(np.float32) * 0.1))
    return p


def flat_host(tree):
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)
            if np.ndim(x)]


@pytest.mark.parametrize("phase", ["imitation", "finetune"])
def test_losses_and_gradients_match_jax_value_and_grad(phase, dataset):
    j_im, j_ft = jax_losses()
    ex = jtrain.load_dataset(dataset)[0]
    jp = jtrain._prepare(ex)
    tp = ttrain._prepare(ex, "cpu")
    host = trained_like_params()
    params = tnet.params_from_numpy(host, "cpu")
    leaves = ttrain._leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    # jitted, as the JAX fit runs them (XLA fuses the op-by-op form
    # differently: the two differ by ~5e-6 relative in the fine-tune loss)
    if phase == "imitation":
        jl, jg = jax.jit(jax.value_and_grad(j_im))(
            host, jp["pod_f"], jp["node_f"], jp["ok"], jp["target"],
            jp["tmask"])
        tl = ttrain.im_loss(params, tp["pod_f"], tp["node_f"], tp["ok"],
                            tp["target"], tp["tmask"])
    else:
        jl, jg = jax.jit(jax.value_and_grad(j_ft))(
            host, jp["pod_f"], jp["node_f"], jp["ok"], jp["vunits"],
            jp["req_n"], jp["free_n"], jp["cont"], jp["valid_rows"])
        tl = ttrain.ft_loss(params, tp["pod_f"], tp["node_f"], tp["ok"],
                            tp["vunits"], tp["req_n"], tp["free_n"],
                            tp["cont"], tp["valid_rows"], **FT_KW)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    tg = torch.autograd.grad(tl, leaves)
    want = flat_host({"node": jg["node"], "pod": jg["pod"]})
    assert len(want) == len(tg) == 8
    for w, g in zip(want, tg):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    assert max(np.abs(w).max() for w in want) > 1e-3


def test_one_adam_step_is_bit_equal_on_the_cpu():
    rng = np.random.RandomState(0)
    host = trained_like_params()
    shapes = [x.shape for x in jax.tree_util.tree_leaves(
        {"node": host["node"], "pod": host["pod"]})]
    draw = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    grads = [draw(s) for s in shapes]
    m = [draw(s) * 0.1 for s in shapes]
    v = [np.abs(draw(s)) * 0.01 for s in shapes]
    params = tnet.params_from_numpy(host, "cpu")
    leaves = [x.clone() for x in ttrain._leaves(params)]
    unf = jax.tree_util.tree_unflatten
    tree = jax.tree_util.tree_structure([np.zeros(1)] * len(shapes))
    jp, jm, jv = jtrain._adam_step(
        unf(tree, [x.numpy().copy() for x in leaves]), unf(tree, grads),
        unf(tree, [x.copy() for x in m]), unf(tree, [x.copy() for x in v]),
        7, 5e-3)
    tm = [torch.from_numpy(x.copy()) for x in m]
    tv = [torch.from_numpy(x.copy()) for x in v]
    ttrain._adam_step(leaves, [torch.from_numpy(g) for g in grads], tm, tv,
                      7, 5e-3)
    for want, got in ((jp, leaves), (jm, tm), (jv, tv)):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w)


def test_fit_end_to_end_matches_the_jax_package(fits):
    (jparams, jrep), (tparams, trep) = fits
    assert trep["examples"] == jrep["examples"] == 2
    np.testing.assert_allclose(trep["imitation"], jrep["imitation"],
                               rtol=1e-4)
    assert len(trep["finetune"]) == len(jrep["finetune"]) == 2
    np.testing.assert_allclose(trep["finetune"][-1], jrep["finetune"][-1],
                               rtol=1e-3)
    # The first fine-tune loss is not gated against the JAX package's
    # (-0.72821): on the node tower's output bias, whose imitation gradient
    # is exactly zero, Adam turns each library's rounding noise into full
    # learning-rate steps of differing sign, and the fine-tune loss (whose
    # null column is not shift-invariant) sees that bias. Pinned here.
    assert trep["finetune"][0] == pytest.approx(-0.73575, abs=2e-5)
    assert isinstance(tparams["tau"], np.float32)
    assert tparams["tau"] == jparams["tau"]
    # the returned params are the host form save_checkpoint writes
    assert tnet.params_hash(tparams) == jnet.params_hash(tparams)


def test_fit_is_deterministic(dataset):
    exs = jtrain.load_dataset(dataset)
    kw = dict(seed=0, imitation_epochs=3, finetune_epochs=2, device="cpu")
    a, b = ttrain.fit(exs, **kw), ttrain.fit(exs, **kw)
    assert tnet.params_hash(a[0]) == tnet.params_hash(b[0])
    assert a[1] == b[1]


def eval_duel(solve_pkg, params, n_pods=192, n_nodes=256, seed=77):
    """Greedy against the learned solve of `params` (host form) in
    `solve_pkg`'s solve on policy_bench's build: (winner, utils)."""
    if solve_pkg == "jax":
        from test_torch_learned import jax_build

        enc, batch, prio = jax_build(n_pods, n_nodes, seed=seed)
        run = lambda learned=None: np.asarray(  # noqa: E731
            jassign.solve_batch(batch, enc.nodes,
                                learned=learned).assigned)[:batch.num_pods]
        choose = jpack.choose_plan_n
    else:
        from test_torch_learned import port_build

        enc, batch, prio = port_build(n_pods, n_nodes, seed=seed)
        run = lambda learned=None: tassign.solve_batch(  # noqa: E731
            batch, enc.nodes, learned=learned,
            device="cpu").assigned[:batch.num_pods].numpy()
        choose = tpack.choose_plan_n
    ga, la = run(), run((params, 1))
    return choose([("greedy", ga), ("learned", la)],
                  batch.req.astype(np.int32), batch.valid,
                  cap_i=np.floor(enc.nodes.capacity_arr).astype(np.int64),
                  priorities=np.asarray(prio))


@pytest.mark.parametrize("trained_by, solved_by", [
    ("port", "port"), ("jax", "jax"), ("jax", "port"), ("port", "jax")])
def test_checkpoints_win_the_duel_in_both_solves(trained_by, solved_by,
                                                 fits):
    (jparams, _), (tparams, _) = fits
    params = tparams if trained_by == "port" else jparams
    winner, utils = eval_duel(solved_by, params)
    assert winner == "learned", utils
    assert utils["learned"]["placed"] >= utils["greedy"]["placed"]


class Recorded(test_torch_duel.Core):
    """tests/test_torch_duel.py's Core with a list as policy_recorder."""

    def __init__(self, pkg, **kw):
        super().__init__(pkg, **kw)
        self.examples = []
        self.core.policy_recorder = self.examples.append


def test_recorder_records_what_the_jax_core_records(monkeypatch):
    """The contended duel trace (both cycles commit the pack plan, equal
    placements in both packages): the port core's recorded examples equal
    the JAX core's, array for array."""
    monkeypatch.setattr(test_torch_duel, "Core", Recorded)
    ref = test_torch_duel.contended_trace(test_torch_duel.REF)
    port = test_torch_duel.contended_trace(test_torch_duel.PORT)
    assert port.record() == ref.record()
    assert len(port.examples) == len(ref.examples) == 2
    for want, got in zip(ref.examples, port.examples):
        assert sorted(got) == sorted(want)
        assert got["winner"] == want["winner"] == "optimal"
        assert got["score_cols"] == want["score_cols"]
        for k, w in want.items():
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(np.asarray(got[k]), w,
                                              err_msg=k)
    # the recorded example is the trainer's input as is
    assert ttrain._prepare(port.examples[0], "cpu") is not None


def test_recorder_failure_never_reaches_the_cycle():
    from yunikorn_tpu_torch.client import synthetic

    def boom(ex):
        raise RuntimeError("disk full")

    c = Recorded(test_torch_duel.PORT)
    c.core.policy_recorder = boom
    c.add_nodes(synthetic.make_kwok_nodes(8))
    c.wave(synthetic.make_sleep_pods(12, "app", queue="root.q",
                                     name_prefix="w"))
    assert len(c.placements()) == 12
    assert c.entries[-1]["solver_policy"] in ("greedy", "optimal")


def test_policy_train_command_writes_a_checkpoint_jax_loads(dataset,
                                                            tmp_path):
    out = str(tmp_path / "ck")
    proc = subprocess.run(
        [sys.executable, "-m", "yunikorn_tpu_torch.cmd.policy_train",
         "--dataset", dataset, "--out", out, "--imitation-epochs", "4",
         "--finetune-epochs", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout)
    assert rep["cycles"] == 2 and rep["epoch"] == 6
    assert rep["winners"] == {"optimal": 2}
    assert "[policy-train] 2 cycles" in proc.stderr
    ck = jnet.load_checkpoint(out)
    assert ck.hash == rep["hash"] == tnet.load_checkpoint(out).hash
    assert ck.manifest["meta"]["report"] == rep["losses"]
