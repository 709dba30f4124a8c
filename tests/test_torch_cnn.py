"""The port's cheap CNN against the JAX package's ``cnn.forward``: the same
JAX-initialised parameters (carried over with ``params_from_jax``) and the
same numpy images give logits and features within atol 1e-5 (fp32 sums in
another order), at the full widths of every configuration the benchmarks
use."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import GENERIC_FAMILY, SPECIALIZED_FAMILY
from repro.models import cnn as jcnn
from repro_torch.common.config import CHEAP_CNNS, CheapCNNConfig
from repro_torch.models import cnn

FAMILY = {**GENERIC_FAMILY, **SPECIALIZED_FAMILY}


def _port_cfg(jcfg) -> CheapCNNConfig:
    return CheapCNNConfig(jcfg.name, input_res=jcfg.input_res,
                          n_blocks=jcfg.n_blocks, width=jcfg.width,
                          n_classes=jcfg.n_classes,
                          feature_dim=jcfg.feature_dim,
                          in_channels=jcfg.in_channels, dtype=jcfg.dtype)


def _jax_tree(jcfg, seed):
    """Parameters from the JAX package's own ``cnn.init``, in the
    benchmarks' pickle form: every leaf a numpy array."""
    params = jax.jit(jcnn.init, static_argnums=1)(jax.random.PRNGKey(seed),
                                                  jcfg)
    return jax.tree.map(np.asarray, params)


_jax_forward = jax.jit(jcnn.forward, static_argnums=2)


@pytest.mark.parametrize("model_id", sorted(FAMILY))
def test_forward_matches_jax(model_id):
    jcfg = FAMILY[model_id][0]
    # a JAX-layout tree drawn with numpy (the JAX init is exercised below)
    tree = cnn.init_params(_port_cfg(jcfg), seed=len(model_id))
    r = np.random.default_rng(3)
    # nonzero norm affine, so scale/bias layouts are exercised too
    for p in tree["blocks"]:
        p["scale"] = r.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = r.normal(0, 0.1, p["bias"].shape).astype(np.float32)
    images = r.random((3, jcfg.input_res, jcfg.input_res, 3),
                      dtype=np.float32)
    lj, fj = _jax_forward(tree, jnp.asarray(images), jcfg)
    model = cnn.build(_port_cfg(jcfg), tree, device="cpu")
    with torch.no_grad():
        lt, ft = model(torch.from_numpy(images))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-5)
    # the JAX tree survives a round trip through the module
    back = cnn.params_to_jax(model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_make_apply_matches_jax_softmax_and_pads(tmp_path):
    """``make_apply`` returns numpy softmax probs and features for a ragged
    batch, from weights that went through the ``--weights`` npz form."""
    jcfg = GENERIC_FAMILY["cheap1"][0]
    assert _port_cfg(jcfg) == CHEAP_CNNS["cheap1"]
    tree = _jax_tree(jcfg, seed=0)
    path = str(tmp_path / "cheap1.npz")
    cnn.save_npz_params(tree, path)
    model = cnn.build(CHEAP_CNNS["cheap1"], cnn.load_npz_params(path),
                      device="cpu")
    apply = cnn.make_apply(model, batch_pad=4)
    images = np.random.default_rng(1).random((5, 32, 32, 3),
                                             dtype=np.float32)
    probs, feats = apply(images)
    lj, fj = _jax_forward(tree, jnp.asarray(images), jcfg)
    np.testing.assert_allclose(probs, np.asarray(jax.nn.softmax(lj, -1)),
                               atol=1e-6)
    np.testing.assert_allclose(feats, np.asarray(fj), atol=1e-5)
    assert probs.shape == (5, 1000) and feats.shape == (5, 128)
    e_probs, e_feats = apply(images[:0])
    assert e_probs.shape == (0, 1000) and e_feats.shape == (0, 128)


def test_make_forward_matches_jax_and_make_apply():
    """The tensor-level forward the fused pipeline runs gives the JAX
    package's softmax probs and features (atol 1e-6 / 1e-5, fp32 summed
    in another order) as tensors, and the same bits as ``make_apply`` at
    the same batch shape."""
    jcfg = GENERIC_FAMILY["cheap1"][0]
    tree = _jax_tree(jcfg, seed=2)
    model = cnn.build(CHEAP_CNNS["cheap1"], tree, device="cpu")
    forward = cnn.make_forward(model)
    images = np.random.default_rng(4).random((8, 32, 32, 3),
                                             dtype=np.float32)
    probs, feats = forward(torch.from_numpy(images))
    assert isinstance(probs, torch.Tensor) and probs.shape == (8, 1000)
    assert feats.shape == (8, 128) and not probs.requires_grad
    lj, fj = _jax_forward(tree, jnp.asarray(images), jcfg)
    np.testing.assert_allclose(probs.numpy(),
                               np.asarray(jax.nn.softmax(lj, -1)), atol=1e-6)
    np.testing.assert_allclose(feats.numpy(), np.asarray(fj), atol=1e-5)
    ap, af = cnn.make_apply(model, batch_pad=8)(images)
    np.testing.assert_array_equal(ap, probs.numpy())
    np.testing.assert_array_equal(af, feats.numpy())


@pytest.mark.parametrize("size,stride,pads", [
    (32, 2, (0, 1)), (16, 2, (0, 1)), (32, 1, (1, 1)), (7, 2, (1, 1)),
    (4, 1, (1, 1)),
])
def test_same_padding_follows_xla(size, stride, pads):
    """SAME with stride 2 on an even size pads (0, 1), not (1, 1)."""
    assert cnn._same_pads(size, stride) == pads


def test_flops_and_plan_match_jax():
    jcfg = GENERIC_FAMILY["cheap1"][0]
    pcfg = CHEAP_CNNS["cheap1"]
    assert cnn._plan(pcfg) == jcnn._plan(jcfg)
    assert pcfg.flops_per_image() == jcfg.flops_per_image()
