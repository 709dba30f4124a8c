"""The port's training substrate against the JAX package's, on the same numpy
inputs: the learning-rate schedules (rtol 1e-6: fp32 transcendental
functions of two libraries), one AdamW ``update`` (atol 1e-7, with the
global-norm clip active and inactive), the cheap CNN's ``loss_fn`` (atol
1e-6) and five ``train`` steps of a tiny CNN from the JAX package's own
initial weights and the same batches (parameters and logged losses
within 1e-5: the two frameworks sum convolution gradients in other
orders).

The rest of the substrate against the JAX package's: gradient compression
(``cast_bf16`` and 50 steps of ``apply_ef``, bit for bit: both round half
to even in the same fp32 order), ``StepTimer`` (the same stragglers and
EMA), ``make_train_step`` on ``tests/test_train.py``'s quadratic and
linear problems over micro-batches {1, 2} x compression {none, bf16,
int8_ef} (5 steps, atol 1e-6: fp32 sums in another order), and the
port's ``CheckpointManager`` (roundtrip with bf16 leaves bit for bit,
pruning, a save that does not see later in-place updates, resume equal
to an uninterrupted run bit for bit, a fake preemption, and the SIGTERM
handler put back when ``train`` returns)."""
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import CheapCNNConfig as JCheapCNNConfig
from repro.models import cnn as jcnn
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.elastic import StepTimer as JStepTimer
from repro.train.train_loop import TrainConfig as JTrainConfig
from repro.train.train_loop import make_train_step as jmake_train_step
from repro.train.train_loop import train as jtrain
from repro_torch.common.config import CheapCNNConfig
from repro_torch.models import cnn
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import PreemptionHandler, StepTimer
from repro_torch.train.train_loop import TrainConfig, make_train_step, train

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


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def test_compression_matches_jax_bitwise():
    """``cast_bf16`` and 50 steps of ``apply_ef`` over gradients whose
    magnitudes span 1e-6 to 1e2, each step's output and residual bit for
    bit."""
    r = np.random.default_rng(0)
    shapes = [(64, 32), (17,), (3, 5, 7)]
    je = jcomp.init_ef_state({i: jnp.zeros(s) for i, s in enumerate(shapes)})
    pe = comp.init_ef_state([torch.zeros(s) for s in shapes])
    for _ in range(50):
        gs = [(r.normal(size=s) * 10 ** r.uniform(-6, 2)).astype(np.float32)
              for s in shapes]
        jd, je = jcomp.apply_ef({i: jnp.asarray(g) for i, g in enumerate(gs)},
                                je)
        pd, pe = comp.apply_ef([torch.from_numpy(g) for g in gs], pe)
        jb = jcomp.cast_bf16({i: jnp.asarray(g) for i, g in enumerate(gs)})
        pb = comp.cast_bf16([torch.from_numpy(g) for g in gs])
        for i in range(len(shapes)):
            for got, want in ((pd[i], jd[i]), (pe[i], je[i]), (pb[i], jb[i])):
                assert got.dtype == torch.float32
                assert np.array_equal(_bits(got.numpy()),
                                      _bits(np.asarray(want)))


def test_step_timer_matches_jax():
    r = np.random.default_rng(1)
    dts = r.exponential(1.0, 300) * np.where(r.random(300) < 0.05, 6.0, 1.0)
    got, want = StepTimer(alpha=0.2), JStepTimer(alpha=0.2)
    for dt in dts:
        got.observe(float(dt))
        want.observe(float(dt))
    assert got.n_stragglers == want.n_stragglers > 0
    assert (got.ema, got.last, got.n_steps) == (want.ema, want.last,
                                                want.n_steps)
    with got.measure():
        pass
    assert got.n_steps == 301 and 0 <= got.last < 1


def _problem(name):
    """``tests/test_train.py``'s problems as (JAX loss, port loss, params
    as numpy, batch as numpy, OptConfig kwargs)."""
    if name == "quadratic":
        x = np.array([[1.0, 2.0], [3.0, 1.0], [0.5, -1.0]], np.float32)
        y = x @ np.array([[1.0], [-1.0]], np.float32)

        def jloss(params, batch, rng):
            l = jnp.mean((jnp.asarray(x) @ params["w"] - jnp.asarray(y)) ** 2)
            return l, {"l": l}

        def loss(params, batch):
            l = torch.mean((torch.from_numpy(x) @ params["w"]
                            - torch.from_numpy(y)) ** 2)
            return l, {"l": l.detach()}

        return (jloss, loss, {"w": np.zeros((2, 1), np.float32)},
                {"dummy": np.zeros((4, 1), np.float32)},
                dict(lr=0.1, warmup_steps=0, total_steps=10))

    def jloss(params, batch, rng):
        return jnp.mean((batch["x"] * params["w"] - 1.0) ** 2), {}

    def loss(params, batch):
        return torch.mean((batch["x"] * params["w"] - 1.0) ** 2), {}

    return (jloss, loss, {"w": np.ones((1,), np.float32)},
            {"x": np.arange(8.0, dtype=np.float32).reshape(8, 1)},
            dict(lr=0.01, warmup_steps=0, total_steps=10, weight_decay=0.0,
                 clip_norm=0.0))


@pytest.mark.parametrize("compression", ["none", "bf16", "int8_ef"])
@pytest.mark.parametrize("n_mb", [1, 2])
@pytest.mark.parametrize("problem", ["quadratic", "linear"])
def test_make_train_step_matches_jax(problem, n_mb, compression):
    jloss, loss, p0, batch, okw = _problem(problem)
    tcfg = dict(n_microbatches=n_mb, compression=compression)
    jstep = jmake_train_step(jloss, jopt.OptConfig(**okw),
                             JTrainConfig(**tcfg), donate=False)
    step = make_train_step(loss, opt.OptConfig(**okw), TrainConfig(**tcfg))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jopt.init(jp)
    jef = jcomp.init_ef_state(jp) if compression == "int8_ef" else 0
    p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    st = opt.init([p["w"]])
    ef = comp.init_ef_state([p["w"]]) if compression == "int8_ef" else 0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(5):
        jp, jst, jef, jm = jstep(jp, jst, jef, jb, jax.random.PRNGKey(0))
        p, st, ef, m = step(p, st, ef, b)
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]),
                                   atol=1e-6, rtol=1e-6)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       atol=1e-6, rtol=1e-6)
        if compression == "int8_ef":
            # residuals are differences of gradient-sized fp32 values, and
            # XLA's fused step rounds the scale's product its own way
            np.testing.assert_allclose(
                ef[0].numpy(), np.asarray(jef["w"]),
                atol=1e-6 * float(jm["grad_norm"]))
    assert st["step"] == int(jst["step"]) == 5
    assert not p["w"].requires_grad          # the flag is the caller's


def test_checkpoint_roundtrip_bf16_bitwise(tmp_path):
    r = np.random.default_rng(2)
    bf = torch.from_numpy(r.normal(size=(5, 3)).astype(np.float32)).to(
        torch.bfloat16)
    tree = {"b": [torch.arange(6).reshape(2, 3), (np.ones(4), None)],
            "a": bf, "c": np.int32(7), "d": 0}
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    ckpt.save(7, tree, extra={"foo": 1})
    step, got, extra = ckpt.restore(device="cpu")
    assert step == 7 and extra == {"foo": 1}
    assert sorted(got) == ["a", "b", "c", "d"]
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"].view(torch.int16), bf.view(torch.int16))
    assert torch.equal(got["b"][0], tree["b"][0])
    assert isinstance(got["b"][1], tuple) and got["b"][1][1] is None
    np.testing.assert_array_equal(got["b"][1][0].numpy(), np.ones(4))
    assert got["c"].dtype == torch.int32 and int(got["c"]) == 7
    assert got["d"].dtype == torch.int64 and int(got["d"]) == 0
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        man = json.load(f)
    # the JAX package's order: a, b[0], b[1][0], c, d
    assert man["dtypes"] == ["bfloat16", "int64", "float64", "int32",
                             "int64"]
    assert man["shapes"][0] == [5, 3] and man["n_leaves"] == 5


def test_checkpoint_prune_and_async_copy(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    x = torch.zeros(4)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"x": x})
        x.add_(1.0)           # in place, right after save: not in step s
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    for s in (3, 4):
        _, got, _ = ckpt.restore(s, device="cpu")
        assert torch.equal(got["x"], torch.full((4,), s - 1.0))
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(device="cpu")


def _quadratic_train(ckpt, steps, **tcfg):
    _, loss, p0, _, _ = _problem("quadratic")
    params = {"w": torch.from_numpy(p0["w"].copy())}

    def data():
        i = 0
        while True:
            i += 1
            yield {"i": torch.full((4, 1), float(i))}

    seen = []
    return train(lambda p, b: (seen.append(float(b["i"][0, 0])) or
                               loss(p, b)), params, data(),
                 opt.OptConfig(lr=0.1, warmup_steps=0, total_steps=100),
                 TrainConfig(steps=steps, log_every=5, **tcfg),
                 ckpt=ckpt), seen


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_resume_equals_uninterrupted_bitwise(tmp_path, compression):
    (want, _), _ = _quadratic_train(None, 20, compression=compression,
                                    n_microbatches=2)
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    (_, _), _ = _quadratic_train(ckpt, 10, compression=compression,
                                 n_microbatches=2, ckpt_every=5)
    assert ckpt.all_steps() == [5, 10]
    (got, hist), seen = _quadratic_train(ckpt, 20, compression=compression,
                                         n_microbatches=2)
    assert hist[0]["step"] == 11                       # resumed
    assert seen[0] == 11.0                             # iterator replayed
    assert torch.equal(got["w"], want["w"])
    assert ckpt.latest_step() == 20


class _FakePreempt:
    """Triggers on the third read of ``triggered``; counts ``restore``."""
    restored = 0

    def __init__(self, *a, **k):
        self.reads = 0

    @property
    def triggered(self):
        self.reads += 1
        return self.reads > 2

    def restore(self):
        _FakePreempt.restored += 1


def test_fake_preemption_checkpoints_and_returns(tmp_path, monkeypatch):
    monkeypatch.setattr(train_loop, "PreemptionHandler", _FakePreempt)
    _FakePreempt.restored = 0
    ckpt = CheckpointManager(str(tmp_path))
    (p, hist), seen = _quadratic_train(ckpt, 100)
    step, tree, extra = ckpt.restore(device="cpu")
    assert extra == {"batches_consumed": step, "preempted": True}
    assert 0 < step < 100 and len(seen) == step
    assert torch.equal(tree[0]["w"], p["w"]) and int(tree[1]["step"]) == step
    assert _FakePreempt.restored == 1


def test_train_puts_the_sigterm_handler_back():
    def mine(signum, frame):
        pass

    old = signal.signal(signal.SIGTERM, mine)
    try:
        _quadratic_train(None, 3)
        assert signal.getsignal(signal.SIGTERM) is mine
        h = PreemptionHandler()
        assert signal.getsignal(signal.SIGTERM) == h._handle
        h._handle(signal.SIGTERM, None)              # no real signal sent
        assert h.triggered
        h.restore()
        assert signal.getsignal(signal.SIGTERM) is mine
    finally:
        signal.signal(signal.SIGTERM, old)
