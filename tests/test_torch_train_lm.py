"""LM training in the port against the JAX package, on reduced olmo-1b
(non-parametric LN, SwiGLU, tied embeddings) and reduced granite-34b
(LayerNorm, GELU, grouped KV, a separate head), on the CPU.

- ``loss_fn`` and its gradients in fp32 against ``jax.value_and_grad`` of
  JAX's ``loss_fn``: within 1e-5 of each leaf's largest |value| (fp32 sums
  in another order).
- Remat (``cfg.remat``) on, under each of the policies ``nothing``,
  ``dots_nobatch`` and ``dots``, and off give the same loss and
  gradients, bit for bit.
- ``train`` of fp32 olmo-1b, 5 steps from JAX's own weights on JAX's own
  batches, plain and with 2 micro-batches and int8 error feedback:
  per-step losses within 1e-5 relative; parameters within 1e-4 (a tenth
  of the learning rate): AdamW divides each moment by its root mean
  square, so an element whose gradient is near zero moves by up to the
  learning rate on an ulp of difference (measured: 1.4e-5 and 4.6e-5).
- bf16 training and the two entry points (``repro_torch.launch.train.main``
  against ``repro.launch.train.main``): losses within 1e-3 relative. The
  bf16 logits of the two LMs differ by up to 2e-2 of the largest logit
  (ROADMAP C9, ``tests/test_torch_transformer.py``); a loss is a mean
  over B x S tokens of differences of both signs (measured: at most
  7e-5 relative over 10 steps).
- The init state (bf16 params, AdamW moments, step) written by the two
  ``CheckpointManager``s: the same leaves, shapes, dtype names and bytes
  (JAX's bf16 leaves load back as 2-byte void arrays, the port's as
  their int16 bits; ROADMAP C13).
- Resume (2 micro-batches, int8 error feedback, bf16) equal to an
  uninterrupted run, bit for bit; the entry point resumes from its
  ``--ckpt-dir`` and does not restart.
"""
import dataclasses
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
from repro.models import transformer as JT
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.train_loop import TrainConfig as JTrainConfig
from repro.train.train_loop import train as jtrain
from repro_torch.common.config import reduced
from repro_torch.configs import get_arch
from repro_torch.launch import train as launch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager, flatten
from repro_torch.train.train_loop import (TrainConfig, param_leaves,
                                          state_tree, train)


def _cfgs(arch, **kw):
    return (reduced(get_arch(arch), **kw), jreduced(jget_arch(arch), **kw))


def _jax_init(jcfg):
    return jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), jcfg))


def _batches(cfg, n, B=4, S=32, seed=2):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = r.integers(0, cfg.vocab_size, (B, S))
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def _grads(cfg, params, toks, labels):
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = T.loss_fn(params, torch.from_numpy(toks),
                              torch.from_numpy(labels), cfg)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), metrics, grads


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-34b"])
def test_loss_fn_and_grads_match_jax(arch):
    cfg, jcfg = _cfgs(arch, dtype="float32")
    jp = _jax_init(jcfg)
    (toks, labels), = _batches(cfg, 1, B=2, S=16, seed=1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, t, y: JT.loss_fn(p, t, y, jcfg), has_aux=True))(
        jp, toks.astype(np.int32), labels.astype(np.int32))
    loss, metrics, grads = _grads(cfg, T.params_from_jax(jp, cfg, "cpu"),
                                  toks, labels)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["nll"]), float(jm["nll"]),
                               rtol=1e-5)
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for g, jgl in zip(grads, jleaves):
        jgl = np.asarray(jgl)
        assert g.shape == jgl.shape
        np.testing.assert_allclose(g.numpy(), jgl, rtol=0,
                                   atol=1e-5 * np.abs(jgl).max())


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-34b"])
def test_remat_on_equals_off_bitwise(arch):
    """Remat off, and on under each of JAX's three policies (``nothing``
    recomputes the layer; ``dots_nobatch`` and ``dots`` keep products):
    the same loss and gradients, bit for bit."""
    cfg, jcfg = _cfgs(arch)                     # the config's bf16
    params = T.params_from_jax(_jax_init(jcfg), cfg, "cpu")
    (toks, labels), = _batches(cfg, 1, seed=3)
    on = dataclasses.replace(cfg, remat=True)
    l0, _, g0 = _grads(cfg, params, toks, labels)
    for name in ("nothing", "dots_nobatch", "dots"):
        policy = dataclasses.replace(on, remat_policy=name)
        l1, _, g1 = _grads(policy, params, toks, labels)
        assert torch.equal(l0, l1), name
        assert all(torch.equal(a, b) for a, b in zip(g0, g1)), name
    with torch.no_grad():                       # serving: no checkpoint
        assert torch.equal(T.prefill(params, torch.from_numpy(toks), on),
                           T.prefill(params, torch.from_numpy(toks), cfg))
    assert L.remat_policy("nothing") is None
    assert callable(L.remat_policy("dots"))
    assert callable(L.remat_policy("dots_nobatch"))
    with pytest.raises(ValueError):
        L.remat_policy("everything")


def _train_both(dtype, n=5, **tkw):
    """5 logged steps of both loops from JAX's weights on the same
    batches: (port history, JAX history, port params, JAX params)."""
    cfg, jcfg = _cfgs("olmo-1b", dtype=dtype)
    jp = _jax_init(jcfg)
    batches = _batches(cfg, n)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=n)
    jparams, jhist = jtrain(
        lambda p, b, r: JT.loss_fn(p, b["t"], b["l"], jcfg),
        jax.tree.map(jnp.asarray, jp),
        iter([{"t": jnp.asarray(a), "l": jnp.asarray(b)}
              for a, b in batches]),
        jopt.OptConfig(**okw), JTrainConfig(steps=n, log_every=1, **tkw))
    params, hist = train(
        lambda p, b: T.loss_fn(p, b["t"], b["l"], cfg),
        T.params_from_jax(jp, cfg, "cpu"),
        iter([{"t": torch.from_numpy(a), "l": torch.from_numpy(b)}
              for a, b in batches]),
        opt.OptConfig(**okw), TrainConfig(steps=n, log_every=1, **tkw))
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] \
        == list(range(1, n + 1))
    return hist, jhist, params, jparams


@pytest.mark.parametrize("tkw", [{}, dict(n_microbatches=2,
                                          compression="int8_ef")],
                         ids=["plain", "mb2-int8_ef"])
def test_train_fp32_matches_jax(tkw):
    hist, jhist, params, jparams = _train_both("float32", **tkw)
    for h, jh in zip(hist, jhist):
        assert set(h) == set(jh)
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-5)
        np.testing.assert_allclose(h["grad_norm"], jh["grad_norm"],
                                   rtol=1e-4)
    got = flatten(T.params_to_jax(params))[0]
    want = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    init = flatten(T.params_to_jax(T.init(_cfgs("olmo-1b")[0], 0, "cpu")))
    assert max(float(np.abs(a - b).max())
               for a, b in zip(got, init[0])) > 1e-3     # trained


def test_train_bf16_losses_match_jax():
    hist, jhist, params, _ = _train_both("bfloat16")
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-3)
    assert params["tok_embed"].dtype == torch.bfloat16


def _loss_lines(text):
    return [(int(s), float(l)) for s, l in
            re.findall(r"step\s+(\d+) loss (\S+) \(", text)]


@pytest.mark.parametrize("flags", [[], ["--microbatches", "2",
                                        "--compression", "int8_ef"]],
                         ids=["plain", "mb2-int8_ef"])
def test_launch_train_matches_jax_entry_point(flags, capsys, monkeypatch,
                                         tmp_path):
    argv = ["--arch", "olmo-1b", "--steps", "10"] + flags
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    assert jlaunch.main() == 0
    want = capsys.readouterr().out
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "5"]
    report = launch.main(argv + ckpt + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]   # arch, params
    g, w = _loss_lines(got), _loss_lines(want)
    assert [s for s, _ in g] == [s for s, _ in w] == list(range(1, 11))
    np.testing.assert_allclose([x for _, x in g], [x for _, x in w],
                               rtol=1e-3)
    assert report["final_loss"] == report["history"][-1]["loss"]
    # a second run on the same directory resumes at step 10: no restart
    again = launch.main(argv + ckpt + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert again["start_step"] == 10 and again["history"] == []
    assert "resuming from step 10" in out and not _loss_lines(out)


def test_init_checkpoint_leaves_equal_jax_bytes(tmp_path):
    """The init state of reduced bf16 olmo-1b as both managers write it:
    (params, AdamW state, no error feedback)."""
    cfg, jcfg = _cfgs("olmo-1b")
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    jm = JCheckpointManager(str(tmp_path / "jax"), async_save=False)
    jm.save(0, (jp, jopt.init(jp), 0))
    params = T.init(cfg, 0, "cpu")
    pm = CheckpointManager(str(tmp_path / "port"), async_save=False)
    pm.save(0, state_tree(params, opt.init(param_leaves(params)), 0))
    jz = np.load(tmp_path / "jax" / "step_00000000" / "leaves.npz")
    pz = np.load(tmp_path / "port" / "step_00000000" / "leaves.npz")
    assert len(jz.files) == len(pz.files) == 3 * 8 + 2
    kinds = set()
    for i in range(len(jz.files)):
        a, b = jz[f"leaf_{i}"], pz[f"leaf_{i}"]
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
        kinds.add((a.dtype.str, b.dtype.str))
    assert kinds == {("|V2", "<i2"), ("<f4", "<f4"), ("<i4", "<i4"),
                     ("<i8", "<i8")}
    import json
    man = [json.load(open(tmp_path / d / "step_00000000" / "manifest.json"))
           for d in ("jax", "port")]
    assert man[0]["dtypes"] == man[1]["dtypes"]
    assert man[0]["shapes"] == man[1]["shapes"]
    _, tree, _ = pm.restore(device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(param_leaves(tree[0]), param_leaves(params)))
    assert tree[0]["tok_embed"].dtype == torch.bfloat16


def test_lm_resume_equals_uninterrupted_bitwise(tmp_path):
    cfg, _ = _cfgs("olmo-1b")
    batches = _batches(cfg, 6)
    tkw = dict(n_microbatches=2, compression="int8_ef", log_every=1)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=6)

    def run(steps, ckpt, **kw):
        return train(lambda p, b: T.loss_fn(p, b["t"], b["l"], cfg),
                     T.init(cfg, 0, "cpu"),
                     iter([{"t": torch.from_numpy(a),
                            "l": torch.from_numpy(b)} for a, b in batches]),
                     ocfg, TrainConfig(steps=steps, **tkw, **kw), ckpt=ckpt)

    want, whist = run(6, None)
    ckpt = CheckpointManager(str(tmp_path))
    run(3, ckpt, ckpt_every=3)
    got, hist = run(6, ckpt)
    assert [h["step"] for h in hist] == [4, 5, 6]
    assert [h["loss"] for h in hist] == [h["loss"] for h in whist[3:]]
    assert all(torch.equal(a, b) for a, b in
               zip(param_leaves(got), param_leaves(want)))
    _, tree, _ = ckpt.restore(device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(param_leaves(tree[0]), param_leaves(want)))
