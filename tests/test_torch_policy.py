"""The port's policy package (policy/features, policy/net) against the JAX
package's on the same numpy inputs.

- Features: pod and node rows equal bit for bit at resource widths 1, 2, 4
  and 6 (the fleet scale too), within an ulp of the jitted reference;
  every column stays finite; two empty nodes of opposite shape differ.
- Towers: the two embeddings and the score matrix within 1e-6 of the JAX
  package's for the committed checkpoint (tests/data/policy_fragmented_v1,
  the JAX package's trainer's output) and a random init; an untrained init
  scores exactly 0.
- Checkpoints: the same RandomState draw in init_params, a checkpoint saved
  by either package loads in the other with the same params_hash and
  manifest, and every
  rejection the JAX package makes (manifest, format, feature version,
  widths, npz sha256, leaf shapes, tower dims, param hash) the port makes
  too.
"""
import hashlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from yunikorn_tpu.policy import features as jf
from yunikorn_tpu.policy import net as jnet
from yunikorn_tpu_torch.policy import features as tf
from yunikorn_tpu_torch.policy import net as tnet

CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "policy_fragmented_v1")
CKPT_HASH = "083e3b745ed6202c"
T = torch.from_numpy


def case(rng, r, n=64, m=32):
    req = rng.randint(0, 1000, size=(n, r)).astype(np.int32)
    cap = rng.randint(1000, 9000, size=(m, r)).astype(np.int32)
    free = (cap - rng.randint(0, 1200, size=(m, r))).astype(np.int32)
    return req, cap, free


@pytest.mark.parametrize("r", [1, 2, 4, 6])
def test_features_equal_the_reference(r):
    """Bit for bit against the JAX functions op by op; within one float32
    ulp of them inside jit, where XLA fuses the column products into the
    sums (a fused multiply-add) and divides by a count as a product."""
    rng = np.random.RandomState(r)
    req, cap, free = case(rng, r)
    inv = np.asarray(jf.inv_capacity_scale(cap))
    tinv = tf.inv_capacity_scale(T(cap))
    np.testing.assert_array_equal(inv, tinv.numpy())
    pod = tf.pod_features(T(req), tinv)
    node = tf.node_features(T(free), T(cap), tinv)
    np.testing.assert_array_equal(np.asarray(jf.pod_features(req, inv)),
                                  pod.numpy())
    np.testing.assert_array_equal(np.asarray(jf.node_features(free, cap, inv)),
                                  node.numpy())
    for want, got in ((jax.jit(jf.pod_features)(req, inv), pod),
                      (jax.jit(jf.node_features)(free, cap, inv), node)):
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=2e-7,
                                   atol=0)
    assert pod.shape == (64, tf.F_POD) and node.shape == (32, tf.F_NODE)
    assert torch.isfinite(pod).all() and torch.isfinite(node).all()


def test_features_at_fleet_scale_and_empty_flavors():
    """The two-flavor fleet's capacities (millicores and memory units at
    4,096 nodes) and two empty nodes of opposite shape, which must embed
    differently."""
    cap = np.tile(np.array([[8000, 4096], [2000, 16384]], np.int32),
                  (2048, 1))
    inv = np.asarray(jf.inv_capacity_scale(cap))
    np.testing.assert_array_equal(inv,
                                  tf.inv_capacity_scale(T(cap)).numpy())
    got = tf.node_features(T(cap), T(cap), T(np.array(inv))).numpy()
    np.testing.assert_array_equal(
        np.asarray(jf.node_features(cap, cap, inv)), got)
    assert not np.allclose(got[0], got[1])


def tower_inputs(r=2):
    rng = np.random.RandomState(11)
    req, cap, free = case(rng, r, n=96, m=48)
    inv = np.asarray(jf.inv_capacity_scale(cap))
    return (np.asarray(jf.pod_features(req, inv)),
            np.asarray(jf.node_features(free, cap, inv)))


@pytest.mark.parametrize("which", ["committed", "random"])
def test_towers_and_scores_within_1e6(which):
    if which == "committed":
        params = jnet.load_checkpoint(CKPT).params
    else:
        params = jnet.init_params(4)
        params["pod"] = (params["pod"][0], params["node"][1])
    pod_f, node_f = tower_inputs()
    tp = tnet.params_from_numpy(params, "cpu")
    want_p = np.asarray(jnet.pod_tower(params, pod_f))
    want_n = np.asarray(jnet.node_tower(params, node_f))
    got_p = tnet.pod_tower(tp, T(pod_f)).numpy()
    got_n = tnet.node_tower(tp, T(node_f)).numpy()
    assert np.abs(want_p - got_p).max() <= 1e-6
    assert np.abs(want_n - got_n).max() <= 1e-6
    assert np.abs(want_p).max() > 0.01 and np.abs(want_n).max() > 0.01
    want_s = np.asarray(jnet.score_matrix(params, pod_f, node_f))
    got_s = tnet.score_matrix(tp, T(pod_f), T(node_f)).numpy()
    assert np.abs(want_s - got_s).max() <= 1e-5 * max(1.0,
                                                      np.abs(want_s).max())
    assert tp["tau"] == float(np.float32(params["tau"]))


def test_untrained_scores_exactly_zero_and_init_draws_match():
    for seed in (0, 5):
        a, b = jnet._flatten(jnet.init_params(seed)), tnet._flatten(
            tnet.init_params(seed))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert jnet.params_hash(jnet.init_params(seed)) == tnet.params_hash(
            tnet.init_params(seed))
    pod_f, node_f = tower_inputs(4)
    tp = tnet.params_from_numpy(tnet.init_params(3), "cpu")
    s = tnet.score_matrix(tp, T(pod_f), T(node_f))
    assert bool((s == 0).all())
    # device-form params come back unchanged, host-form leaves are copied
    assert tnet.params_from_numpy(tp, "cpu")["pod"][0][0].data_ptr() == \
        tp["pod"][0][0].data_ptr()


def test_committed_checkpoint_loads_in_both_packages():
    j, t = jnet.load_checkpoint(CKPT), tnet.load_checkpoint(CKPT)
    assert j.hash == t.hash == CKPT_HASH
    assert j.epoch == t.epoch and j.manifest == t.manifest
    for k, v in jnet._flatten(j.params).items():
        np.testing.assert_array_equal(v, tnet._flatten(t.params)[k])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_load_with_one_hash(tmp_path, writer):
    params = jnet.init_params(7)
    params["pod"] = (params["pod"][0], params["node"][1])
    prefix = str(tmp_path / "ck")
    save, load = ((jnet.save_checkpoint, tnet.load_checkpoint)
                  if writer == "jax" else
                  (tnet.save_checkpoint, jnet.load_checkpoint))
    saved = save(prefix, params, epoch=3, meta={"note": writer})
    loaded = load(prefix)
    assert saved.hash == loaded.hash == jnet.params_hash(params) \
        == tnet.params_hash(params)
    assert loaded.epoch == 3 and loaded.manifest["meta"] == {"note": writer}
    # the port writes the JAX package's manifest (the npz's zip entries
    # carry their write time, so its sha256 is compared through the load)
    other = str(tmp_path / "other")
    (jnet.save_checkpoint if writer == "port" else tnet.save_checkpoint)(
        other, params, epoch=3, meta={"note": writer})
    manifests = []
    for pfx in (prefix, other):
        with open(pfx + ".json") as f:
            m = json.load(f)
        m.pop("npz_sha256")
        manifests.append(m)
    assert manifests[0] == manifests[1]
    # device-form params hash as their host form
    assert tnet.params_hash(tnet.params_from_numpy(params, "cpu")) \
        == saved.hash


def _rewrite_manifest(prefix, **changes):
    with open(prefix + ".json") as f:
        manifest = json.load(f)
    manifest.update(changes)
    with open(prefix + ".json", "w") as f:
        json.dump(manifest, f)


def _rewrite_npz(prefix, leaves):
    np.savez(prefix + ".npz", **leaves)
    with open(prefix + ".npz", "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    _rewrite_manifest(prefix, npz_sha256=sha)


def _corrupt_payload(prefix):
    with open(prefix + ".npz", "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef")


def _drift_leaf(prefix):
    leaves = jnet._flatten(jnet.init_params(0))
    leaves["pod_0_w"] = np.zeros((jf.F_POD + 1, leaves["pod_0_w"].shape[1]),
                                 np.float32)
    _rewrite_npz(prefix, leaves)


def _tower_dims(prefix):
    leaves = jnet._flatten(jnet.init_params(0, emb=8))
    leaves["node_1_w"] = np.zeros((32, 16), np.float32)
    leaves["node_1_b"] = np.zeros((16,), np.float32)
    _rewrite_npz(prefix, leaves)
    _rewrite_manifest(prefix, leaves={k: [list(v.shape), "float32"]
                                      for k, v in leaves.items()})


def _param_hash(prefix):
    leaves = jnet._flatten(jnet.init_params(0))
    leaves["tau"] = np.float32(0.5)
    _rewrite_npz(prefix, leaves)


REJECTIONS = {
    "manifest": (lambda p: os.remove(p + ".json"), "manifest unreadable"),
    "format": (lambda p: _rewrite_manifest(p, format=2), "format"),
    "feature_version": (lambda p: _rewrite_manifest(
        p, feature_version=jf.FEATURE_VERSION + 1), "feature schema"),
    "widths": (lambda p: _rewrite_manifest(p, f_pod=9), "width mismatch"),
    "npz_missing": (lambda p: os.remove(p + ".npz"), "params unreadable"),
    "npz_sha256": (_corrupt_payload, "sha256 mismatch"),
    "leaf_shape": (_drift_leaf, "leaf pod_0_w shape"),
    "tower_dims": (_tower_dims, "tower dims"),
    "param_hash": (_param_hash, "param content hash"),
}


@pytest.mark.parametrize("reason", sorted(REJECTIONS))
def test_every_reference_rejection_rejects_in_the_port(tmp_path, reason):
    prefix = str(tmp_path / "ck")
    jnet.save_checkpoint(prefix, jnet.init_params(0), epoch=1)
    spoil, match = REJECTIONS[reason]
    spoil(prefix)
    with pytest.raises(jnet.CheckpointError, match=match):
        jnet.load_checkpoint(prefix)
    with pytest.raises(tnet.CheckpointError, match=match):
        tnet.load_checkpoint(prefix)
