"""The trainer and the usage mirror on the card against the CPU.

This module imports torch, the port and chip_smoke's helpers only, so it
runs where the card is and JAX is not:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_train_card.py

Without a CUDA device every test skips."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from yunikorn_tpu_torch.ops import gate_solve
from yunikorn_tpu_torch.policy import net, train

GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fit on the card")


def dataset(tmp_path, cycles=2):
    """scripts/policy_bench.py's recording at 128 x 64 (two duels)."""
    w = train.DatasetWriter(str(tmp_path))
    cs.train_record(torch.device("cpu"), w, 128, 64, range(cycles))
    return train.load_dataset(str(tmp_path))


@pytest.mark.cuda
def test_two_fits_on_the_card_give_one_hash(tmp_path):
    needs_card()
    exs = dataset(tmp_path)
    kw = dict(seed=0, imitation_epochs=30, finetune_epochs=20)
    a = train.fit(exs, device="cuda", **kw)
    b = train.fit(exs, device="cuda", **kw)
    assert net.params_hash(a[0]) == net.params_hash(b[0])
    assert a[1] == b[1]
    cpu = train.fit(exs, device="cpu", **kw)
    np.testing.assert_allclose(a[1]["imitation"], cpu[1]["imitation"],
                               rtol=1e-4)
    np.testing.assert_allclose(a[1]["finetune"][-1], cpu[1]["finetune"][-1],
                               rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["imitation", "finetune"])
def test_losses_and_gradients_on_the_card_match_the_cpu(phase, tmp_path):
    needs_card()
    ex = dataset(tmp_path, cycles=1)[0]
    rng = np.random.RandomState(3)
    host = net.init_params(0)
    (w1, b1), (w2, b2) = host["pod"]
    host["pod"] = ((w1, b1), (rng.standard_normal(w2.shape).astype(
        np.float32) * 0.3, rng.standard_normal(b2.shape).astype(
        np.float32) * 0.1))
    got = {}
    for dev in ("cuda", "cpu"):
        p = train._prepare(ex, dev)
        params = net.params_from_numpy(host, dev)
        leaves = train._leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        with train._full_f32_matmul():
            if phase == "imitation":
                loss = train.im_loss(params, p["pod_f"], p["node_f"],
                                     p["ok"], p["target"], p["tmask"])
            else:
                loss = train.ft_loss(params, p["pod_f"], p["node_f"],
                                     p["ok"], p["vunits"], p["req_n"],
                                     p["free_n"], p["cont"], p["valid_rows"],
                                     beta=4.0, overload_w=2.0,
                                     contention_w=0.05)
            grads = torch.autograd.grad(loss, leaves)
        got[dev] = (float(loss.detach()), [g.cpu().numpy() for g in grads])
    np.testing.assert_allclose(got["cuda"][0], got["cpu"][0], rtol=1e-6)
    for a, b in zip(got["cuda"][1], got["cpu"][1]):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.cuda
def test_usage_ops_and_mirror_on_the_card():
    """chip_smoke's mirror check: usage_apply / usage_fold bit-equal to the
    CPU, and the card's mirror at divergence 0 through its ledger tape."""
    needs_card()
    out = cs.shard_mirror(torch.device("cuda"))
    assert out["apply_fold_bit_equal"] and out["divergence"] == 0
    assert out["device"].startswith("cuda")
    dev = torch.zeros((2, 8, 4), dtype=torch.int64, device="cuda")
    idx = torch.zeros(8, dtype=torch.int64, device="cuda")
    gate_solve.usage_apply(dev, 1, idx, idx,
                           torch.full((8,), 2**59, dtype=torch.int64,
                                      device="cuda"))
    assert int(gate_solve.usage_fold(dev)[0, 0]) == 8 * 2**59
