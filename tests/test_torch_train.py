"""The port's training substrate against the JAX package's, on the same numpy
inputs: the learning-rate schedules (rtol 1e-6: fp32 transcendental
functions of two libraries), one AdamW ``update`` (atol 1e-7, with the
global-norm clip active and inactive), the cheap CNN's ``loss_fn`` (atol
1e-6) and five ``train`` steps of a tiny CNN from the JAX package's own
initial weights and the same batches (parameters and logged losses
within 1e-5: the two frameworks sum convolution gradients in other
orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import CheapCNNConfig as JCheapCNNConfig
from repro.models import cnn as jcnn
from repro.train import optimizer as jopt
from repro.train.train_loop import TrainConfig as JTrainConfig
from repro.train.train_loop import train as jtrain
from repro_torch.common.config import CheapCNNConfig
from repro_torch.models import cnn
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import TrainConfig, train

TINY = dict(name="tiny", input_res=8, n_blocks=1, width=8, n_classes=5,
            feature_dim=16)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(schedule):
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, schedule=schedule,
               min_lr_frac=0.1)
    got = [opt.lr_at(opt.OptConfig(**cfg), s) for s in range(0, 120, 3)]
    want = [float(jopt.lr_at(jopt.OptConfig(**cfg), s))
            for s in range(0, 120, 3)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert all(isinstance(x, float) for x in got)


@pytest.mark.parametrize("clip_norm,step", [(1.0, 0), (100.0, 0),
                                            (1.0, 7), (0.0, 3)])
def test_adamw_update_matches_jax(clip_norm, step):
    """One step over a matrix (decayed) and a vector (not decayed), from
    non-zero moments; clip 1.0 clips these gradients, 100 and 0 do not."""
    r = np.random.default_rng(step)
    names = ("w", "b")
    p = {"w": r.normal(size=(6, 4)).astype(np.float32),
         "b": r.normal(size=(4,)).astype(np.float32)}
    g = {k: r.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    m = {k: r.normal(0, 0.1, v.shape).astype(np.float32)
         for k, v in p.items()}
    v2 = {k: r.random(v.shape).astype(np.float32) * 0.1
          for k, v in p.items()}
    kw = dict(lr=0.01, warmup_steps=2, total_steps=20, weight_decay=0.05,
              clip_norm=clip_norm)
    jp, jstate, jm = jopt.update(
        {k: jnp.asarray(x) for k, x in p.items()},
        {k: jnp.asarray(x) for k, x in g.items()},
        {"m": {k: jnp.asarray(x) for k, x in m.items()},
         "v": {k: jnp.asarray(x) for k, x in v2.items()},
         "step": jnp.asarray(step, jnp.int32)}, jopt.OptConfig(**kw))

    params = [torch.from_numpy(p[k].copy()) for k in names]
    state = {"m": [torch.from_numpy(m[k]) for k in names],
             "v": [torch.from_numpy(v2[k]) for k in names], "step": step}
    om = opt.update(params, [torch.from_numpy(g[k]) for k in names], state,
                    opt.OptConfig(**kw))
    assert state["step"] == step + 1
    for i, k in enumerate(names):
        np.testing.assert_allclose(params[i].numpy(), np.asarray(jp[k]),
                                   atol=1e-7, rtol=0)
        np.testing.assert_allclose(state["m"][i].numpy(),
                                   np.asarray(jstate["m"][k]), atol=1e-7)
        np.testing.assert_allclose(state["v"][i].numpy(),
                                   np.asarray(jstate["v"][k]), atol=1e-7)
    np.testing.assert_allclose(float(om["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(om["lr"], float(jm["lr"]), rtol=1e-6)
    # the clip engaged at 1.0 and not at 100
    assert (float(om["grad_norm"]) > 1.0) and float(om["grad_norm"]) < 100.0


@pytest.mark.parametrize("weighted", [False, True])
def test_loss_fn_matches_jax(weighted):
    jcfg = JCheapCNNConfig(**TINY)
    tree = _np_tree(jcnn.init(jax.random.PRNGKey(1), jcfg))
    r = np.random.default_rng(2)
    x = r.random((12, 8, 8, 3), dtype=np.float32)
    y = r.integers(0, 5, 12).astype(np.int32)
    w = (r.random(5) + 0.5).astype(np.float32) if weighted else None
    jl, jmet = jcnn.loss_fn(tree, jnp.asarray(x), jnp.asarray(y), jcfg,
                            label_weights=None if w is None
                            else jnp.asarray(w))
    model = cnn.build(CheapCNNConfig(**TINY), tree, device="cpu")
    loss, met = cnn.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y),
                            label_weights=None if w is None
                            else torch.from_numpy(w))
    assert loss.requires_grad and not met["nll"].requires_grad
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-6)
    np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]),
                               atol=1e-6)
    assert float(met["acc"]) == float(jmet["acc"])


def test_count_params_matches_jax():
    for kw in (TINY, dict(name="spec1", input_res=32, n_blocks=4, width=32,
                          feature_dim=128, n_classes=7)):
        assert cnn.count_params(CheapCNNConfig(**kw)) == \
            jcnn.count_params(JCheapCNNConfig(**kw))


def _batches(seed, n=5):
    r = np.random.default_rng(seed)
    return [(r.random((16, 8, 8, 3), dtype=np.float32),
             r.integers(0, 5, 16).astype(np.int32)) for _ in range(n)]


def test_train_matches_jax_from_a_shared_init():
    jcfg = JCheapCNNConfig(**TINY)
    tree = _np_tree(jcnn.init(jax.random.PRNGKey(3), jcfg))
    batches = _batches(4)
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=5, weight_decay=1e-4)

    def jloss(params, batch, rng):
        return jcnn.loss_fn(params, batch["x"], batch["y"], jcfg)

    jparams, jhist = jtrain(
        jloss, jax.tree.map(jnp.asarray, tree),
        iter([{"x": jnp.asarray(x), "y": jnp.asarray(y)}
              for x, y in batches]),
        jopt.OptConfig(**ocfg), JTrainConfig(steps=5, log_every=2))

    model = cnn.build(CheapCNNConfig(**TINY), tree, device="cpu")
    model, hist = train(
        lambda m, b: cnn.loss_fn(m, b["x"], b["y"]), model,
        iter([{"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
              for x, y in batches]),
        opt.OptConfig(**ocfg), TrainConfig(steps=5, log_every=2))

    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [1, 2, 4]
    for h, jh in zip(hist, jhist):
        assert set(h) == {"loss", "nll", "acc", "lr", "grad_norm", "step",
                          "step_time_s"} == set(jh)
        np.testing.assert_allclose(h["loss"], jh["loss"], atol=1e-5)
        np.testing.assert_allclose(h["lr"], jh["lr"], rtol=1e-6)
        np.testing.assert_allclose(h["grad_norm"], jh["grad_norm"],
                                   rtol=1e-4)
    got = jax.tree.leaves(cnn.params_to_jax(model))
    want = jax.tree.leaves(_np_tree(jparams))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    # training moved the weights
    assert max(float(np.abs(a - b).max()) for a, b in
               zip(got, jax.tree.leaves(tree))) > 1e-3


@pytest.mark.parametrize("kw", [dict(n_microbatches=2),
                                dict(compression="bf16"),
                                dict(ckpt_every=10)])
def test_unsupported_train_config_raises(kw):
    model = cnn.build(CheapCNNConfig(**TINY),
                      cnn.init_params(CheapCNNConfig(**TINY), 0), "cpu")
    with pytest.raises(NotImplementedError):
        train(lambda m, b: cnn.loss_fn(m, b["x"], b["y"]), model,
              iter([]), opt.OptConfig(), TrainConfig(**kw))
