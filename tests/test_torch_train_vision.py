"""Training of the vision and diffusion models in the port against the JAX
package, on the CPU: the train loop's rng, the training entry point's
ViT, DiT and EfficientNet branches, and a resumed DiT run.

- The loop's rng is JAX's: ``key(seed)``, split each step, the step's key
  split once more per micro-batch. A loss that draws from it (normals)
  gives JAX's losses and parameters within 1e-6, plain and with 2
  micro-batches; a loss without an rng is called without one.
- ``vit_data`` and ``dit_data`` give the JAX entry point's batches, bit
  for bit (the port makes a class's prototype when it is first drawn).
- ``repro_torch.launch.train.main`` against ``repro.launch.train.main``
  on reduced vit-s16, dit-s2 (2 micro-batches) and efficientnet-b7 in
  fp32 (``reduced`` patched to fp32 in both entry points): the same
  first line and loss lines within 1e-3 relative. JAX's eager
  EfficientNet ``init`` takes ~18 s on this CPU; its entry point is
  handed the port's draw, which ``tests/test_torch_vision.py`` holds
  bitwise equal to it.
- A DiT run resumed from a step-3 checkpoint to step 6 restarts its rng
  at ``key(seed)``, as JAX's does: the port's resumed losses equal JAX's
  resumed losses (within 1e-5), not the uninterrupted run's.
"""
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import reduced as jreduced
from repro.configs import get_arch as jget_arch
from repro.launch import train as jlaunch
from repro.models import dit as JD
from repro.models import efficientnet as JE
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.train_loop import TrainConfig as JTrainConfig
from repro.train.train_loop import train as jtrain
from repro_torch.common import prng
from repro_torch.common.config import reduced
from repro_torch.configs import get_arch
from repro_torch.launch import train as launch
from repro_torch.models import dit as D
from repro_torch.models import efficientnet as E
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                          takes_rng, train)


@pytest.mark.parametrize("n_mb", [1, 2])
def test_loop_rng_is_jax_s(n_mb):
    w0 = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    batches = [np.random.default_rng(i).normal(size=(4, 2, 3)).astype(
        np.float32) for i in range(5)]
    okw = dict(lr=1e-2, warmup_steps=1, total_steps=5)
    tkw = dict(steps=5, log_every=1, n_microbatches=n_mb, seed=3)

    def jloss(p, b, r):
        eps = jax.random.normal(r, b["x"].shape, jnp.float32)
        return jnp.mean(jnp.square(p["w"] * b["x"] - eps)), {}

    def loss(p, b, r):
        eps = prng.normal(r, b["x"].shape)
        return torch.mean(torch.square(p["w"] * b["x"] - eps)), {}

    jp, jh = jtrain(jloss, {"w": jnp.asarray(w0)},
                    iter([{"x": jnp.asarray(b)} for b in batches]),
                    jopt.OptConfig(**okw), JTrainConfig(**tkw))
    p, h = train(loss, {"w": torch.from_numpy(w0.copy())},
                 iter([{"x": torch.from_numpy(b)} for b in batches]),
                 opt.OptConfig(**okw), TrainConfig(**tkw))
    np.testing.assert_allclose([x["loss"] for x in h],
                               [x["loss"] for x in jh], rtol=1e-6)
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]),
                               rtol=0, atol=1e-6)
    assert takes_rng(loss) and takes_rng(lambda *a: a)
    assert not takes_rng(lambda p, b: None)
    step = make_train_step(loss, opt.OptConfig(**okw), TrainConfig())
    with pytest.raises(ValueError, match="rng"):
        step({"w": torch.zeros(2, 3)}, opt.init([torch.zeros(2, 3)]), 0,
             {"x": torch.from_numpy(batches[0])})


def test_vit_and_dit_data_equal_jax_batches():
    vcfg, jvcfg = reduced(get_arch("vit-s16")), jreduced(
        jget_arch("vit-s16"))
    dcfg, jdcfg = reduced(get_arch("dit-s2")), jreduced(jget_arch("dit-s2"))
    ecfg, jecfg = reduced(get_arch("efficientnet-b7")), jreduced(
        jget_arch("efficientnet-b7"))
    pairs = [(launch.vit_data(vcfg, 5, seed=2, device="cpu"),
              jlaunch.vit_data(jvcfg, 5, seed=2)),
             (launch.vit_data(ecfg, 3, device="cpu"),
              jlaunch.vit_data(jecfg, 3)),
             (launch.dit_data(dcfg, 4, seed=1, device="cpu"),
              jlaunch.dit_data(jdcfg, 4, seed=1))]
    for got_it, want_it in pairs:
        for _ in range(3):
            got, want = next(got_it), next(want_it)
            assert got.keys() == want.keys()
            for k in got:
                g, w = got[k].numpy(), np.asarray(want[k])
                assert g.shape == w.shape
                assert g.dtype == (np.float32 if w.dtype == np.float32
                                   else np.int64)
                np.testing.assert_array_equal(g, w)


def _loss_lines(text):
    return [(int(s), float(x)) for s, x in
            re.findall(r"step\s+(\d+) loss (\S+) \(", text)]


@pytest.mark.parametrize("arch,flags", [
    ("vit-s16", []), ("dit-s2", ["--microbatches", "2"]),
    ("efficientnet-b7", [])])
def test_launch_train_fp32_matches_jax(arch, flags, capsys, monkeypatch):
    monkeypatch.setattr(jlaunch, "reduced",
                        lambda c, **k: jreduced(c, dtype="float32", **k))
    monkeypatch.setattr(launch, "reduced",
                        lambda c, **k: reduced(c, dtype="float32", **k))
    if arch == "efficientnet-b7":
        cfg = reduced(get_arch(arch), dtype="float32")
        drawn = jax.tree.map(jnp.asarray, E.params_to_jax(
            *E.init(cfg, 0, "cpu")))
        monkeypatch.setattr(JE, "init", lambda rng, c: drawn)
    argv = ["--arch", arch, "--steps", "6", "--batch", "4"] + flags
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    assert jlaunch.main() == 0
    want = capsys.readouterr().out
    report = launch.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]   # arch, params
    g, w = _loss_lines(got), _loss_lines(want)
    assert [s for s, _ in g] == [s for s, _ in w] == list(range(1, 7))
    np.testing.assert_allclose([x for _, x in g], [x for _, x in w],
                               rtol=1e-3)
    assert report["final_loss"] == report["history"][-1]["loss"]


def test_registry_takes_every_jax_arch_id():
    from repro.configs import ARCH_IDS as J_IDS
    assert launch.parse_args(["--arch", "vit-l16"]).arch == "vit-l16"
    assert launch.ARCH_IDS == J_IDS and len(J_IDS) == 10
    for a in J_IDS:
        assert type(get_arch(a)).__name__ == type(jget_arch(a)).__name__


def test_dit_resume_restarts_the_rng_as_jax_does(tmp_path):
    cfg = reduced(get_arch("dit-s2"), dtype="float32")
    jcfg = jreduced(jget_arch("dit-s2"), dtype="float32")
    jp0 = JD.init(jax.random.PRNGKey(0), jcfg)
    batches = [next(launch.dit_data(cfg, 4, seed=s, device="cpu"))
               for s in range(6)]
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=6)

    def run_jax(steps, ckpt, **kw):
        return jtrain(
            lambda p, b, r: JD.loss_fn(p, b["latents"], b["labels"], r,
                                       jcfg),
            jax.tree.map(jnp.array, jp0),
            iter([{k: jnp.asarray(v.numpy()) for k, v in b.items()}
                  for b in batches]),
            jopt.OptConfig(**okw),
            JTrainConfig(steps=steps, log_every=1, **kw), ckpt=ckpt)[1]

    def run(steps, ckpt, **kw):
        return train(
            lambda p, b, r: D.loss_fn(p, b["latents"], b["labels"], r, cfg),
            D.params_from_jax(jax.tree.map(np.asarray, jp0), cfg, "cpu"),
            iter(batches), opt.OptConfig(**okw),
            TrainConfig(steps=steps, log_every=1, **kw), ckpt=ckpt)[1]

    run_jax(3, JCheckpointManager(str(tmp_path / "jax")), ckpt_every=3)
    jres = run_jax(6, JCheckpointManager(str(tmp_path / "jax")))
    run(3, CheckpointManager(str(tmp_path / "port")), ckpt_every=3)
    res = run(6, CheckpointManager(str(tmp_path / "port")))
    whole = run(6, None)
    assert [h["step"] for h in res] == [h["step"] for h in jres] == [4, 5, 6]
    got = [h["loss"] for h in res]
    np.testing.assert_allclose(got, [h["loss"] for h in jres], rtol=1e-5)
    # the uninterrupted run drew other timesteps and noise for steps 4-6
    assert max(abs(a - b["loss"]) / b["loss"]
               for a, b in zip(got, whole[3:])) > 1e-2
