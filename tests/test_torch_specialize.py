"""The port's ``specialize`` (§4.3) against the JAX package's: the edge cases
of ``tests/test_specialize.py`` (Ls above the observed classes, a single
class, an empty sample), and a few training steps from the JAX package's
own initial weights (``init=``), which must give the same class map and
parameters within atol 1e-5 (the two frameworks sum convolution
gradients in other orders)."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.common.config import CheapCNNConfig as JCheapCNNConfig
from repro.core.specialize import specialize as jax_specialize
from repro.models import cnn as jcnn
from repro_torch.common.config import CheapCNNConfig
from repro_torch.core.specialize import (SpecializedModel,
                                         estimate_distribution, specialize,
                                         train_generic)
from repro_torch.models import cnn

TINY = dict(name="tiny", input_res=8, n_blocks=1, width=8, feature_dim=16)
BASE = CheapCNNConfig(**TINY)


def _sample(labels, seed=0):
    r = np.random.default_rng(seed)
    crops = r.random((len(labels), 8, 8, 3)).astype(np.float32)
    return crops, np.asarray(labels)


def test_ls_larger_than_observed_classes():
    crops, labels = _sample([3, 3, 3, 7, 7, 3, 7, 3])
    sm = specialize(crops, labels, Ls=6, base_cfg=BASE, steps=2,
                    batch_size=4, device="cpu")
    np.testing.assert_array_equal(sm.class_map.global_ids, [3, 7])
    assert sm.class_map.n_local == 3            # 2 observed + OTHER
    assert sm.cfg.n_classes == 3 and sm.cfg.name == "tiny-spec6"
    assert all(np.isfinite(h["loss"]) for h in sm.history)


def test_single_class_sample_weights_finite():
    crops, labels = _sample([5] * 10, seed=1)
    sm = specialize(crops, labels, Ls=4, base_cfg=BASE, steps=2,
                    batch_size=4, device="cpu")
    np.testing.assert_array_equal(sm.class_map.global_ids, [5])
    assert sm.class_map.n_local == 2
    assert all(np.isfinite(h["loss"]) for h in sm.history)
    probs, feats = sm.make_apply(batch_pad=4, device="cpu")(crops)
    assert np.isfinite(probs).all() and np.isfinite(feats).all()
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)


def test_empty_sample_does_not_nan():
    classes, counts = estimate_distribution(np.zeros((0,), np.int64))
    assert len(classes) == 0 and len(counts) == 0
    labels = np.array([4, 9, 9, 4, 9, 1])
    got = estimate_distribution(labels)
    from repro.core.specialize import estimate_distribution as jed
    for a, b in zip(got, jed(labels)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("Ls,seed", [(2, 0), (5, 3)])
def test_specialize_matches_jax_from_a_shared_init(Ls, seed):
    r = np.random.default_rng(seed)
    labels = r.choice([11, 12, 13, 14, 40], size=60,
                      p=[0.4, 0.25, 0.15, 0.15, 0.05])
    crops, _ = _sample(labels, seed)
    kw = dict(Ls=Ls, steps=6, batch_size=16, lr=3e-3, seed=seed)
    want = jax_specialize(crops, labels,
                          base_cfg=JCheapCNNConfig(**TINY), **kw)
    tree = jax.tree.map(np.asarray, jcnn.init(
        jax.random.PRNGKey(seed),
        dataclasses.replace(JCheapCNNConfig(**TINY),
                            n_classes=want.class_map.n_local)))
    got = specialize(crops, labels, base_cfg=BASE, init=tree, device="cpu",
                     **kw)
    np.testing.assert_array_equal(got.class_map.global_ids,
                                  want.class_map.global_ids)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert [h["step"] for h in got.history] == \
        [h["step"] for h in want.history]
    for h, jh in zip(got.history, want.history):
        np.testing.assert_allclose(h["loss"], jh["loss"], atol=1e-5)
    leaves = jax.tree.leaves(got.params)
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, want.params))
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    # the forward of the trained model agrees with the JAX package's
    probs, feats = got.make_apply(device="cpu")(crops)
    jprobs, jfeats = want.make_apply()(crops)
    np.testing.assert_allclose(probs, jprobs, atol=1e-5)
    np.testing.assert_allclose(feats, jfeats, atol=1e-5)


def test_default_init_is_the_ports_seeded_tree_and_generic_trains():
    crops, labels = _sample([1, 2, 2, 3] * 4)
    a = specialize(crops, labels, Ls=2, base_cfg=BASE, steps=0,
                   device="cpu")
    want = cnn.init_params(a.cfg, seed=0)
    for x, y in zip(jax.tree.leaves(a.params), jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, y)
    # the port's seeded tree is the JAX package's: threefry, bit for bit
    jwant = jcnn.init(jax.random.PRNGKey(0),
                      JCheapCNNConfig(**dataclasses.asdict(a.cfg)))
    for x, y in zip(jax.tree.leaves(a.params), jax.tree.leaves(jwant)):
        np.testing.assert_array_equal(x, np.asarray(y))
    g = train_generic(crops, labels, dataclasses.replace(BASE, n_classes=5),
                      steps=4, batch_size=8, device="cpu")
    assert isinstance(g, SpecializedModel) and g.class_map is None
    assert [h["step"] for h in g.history] == [1, 2, 3, 4]
    fwd = g.make_forward(device="cpu")
    import torch
    probs, _ = fwd(torch.from_numpy(crops))
    assert probs.shape == (len(crops), 5)
