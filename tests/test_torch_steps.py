"""The port's step builders (``repro_torch.launch.steps``) against the JAX
package's (``repro.launch.steps``), on the CPU. JAX's specs are built on a
(1, 1) ``("data", "model")`` mesh and run jitted on concrete arrays; the
port's run on CPU tensors of the same values, the weights carried across
with each model's ``params_from_jax`` (EfficientNet's the other way, from
the port's draw: JAX's eager EfficientNet ``init`` is slow on a CPU, and
``tests/test_torch_vision.py`` holds the two draws bitwise equal).

- Spec metadata, for every (arch, cell) of the registry through ``build``
  at the reduced configs (``cfg_overrides``), the long cells also as the
  window variant: ``name``, ``skip_reason`` and ``donate_argnums`` equal
  JAX's, and ``args`` are meta tensors whose shapes and dtypes equal JAX's
  ``ShapeDtypeStruct``s leaf for leaf (the port's AdamW ``step`` and a
  decode step's ``cache_len`` are Python ints where JAX has int32
  scalars).
- Train steps of every family in fp32, one step from the same weights
  and batch: the loss within 1e-5 relative, the updated parameters and
  AdamW's ``m`` each within 1e-5 of their leaf's largest |value| (fp32
  sums in another order, as ``tests/test_torch_train_lm.py`` holds
  them), ``v``, a square of the gradient, within 2e-5, and a parameter
  also within a tenth of the learning rate (that test's bound: AdamW's
  step divides by the gradient's size); each parameter's change in the
  step also within 1e-5 of its leaf's largest change, one fp32 ulp of
  the new value and that tenth (at the warm-up's first learning rate a
  whole update is smaller than 1e-5 of a weight). LM cases: olmo-1b plain, and in
  2 micro-batches with ``grad_reduce_dtype="bf16"``, where ``m`` and
  ``v`` may also differ by one bf16 ulp of a gradient (at most 2**-7 of
  it in ``m``, 2**-6 in ``v``): the two fp32 gradients differ by ~1e-7
  relative, and a value that close to a bf16 rounding midpoint rounds to
  either side; the MoE LM (moonshot, its config's 4 micro-batches) on
  inputs whose router top-k margin is at least 1e-4 in every call
  (ROADMAP C14). EfficientNet at 64 px; its ``project`` batch norms'
  biases have a zero gradient in exact arithmetic, so both packages'
  hold rounding noise there: ``m``/``v`` held to 1e-5 of the model's
  largest, the parameters to 2 learning rates (AdamW divides by the
  noise's own size); the new batch-norm state to rtol 1e-5, atol 1e-6,
  as ``tests/test_torch_vision.py`` holds it.
- Serve steps: the prefill logits within 1e-5 of the largest |logit|,
  and in ``prefill_batch_chunks=2`` parts bitwise the unchunked step's;
  the long-prefill recipe's halves and query blocks; decode logits and
  cache over several steps, and the window variant's past its window;
  DiT's sampler at 2 steps, ViT and EfficientNet serving, within 1e-5.
- The serve route (``layers.serve_attn_impl``): ``"flash"`` only for
  causal attention without a window, a head width the kernel is built
  for, and activations on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as JST
from repro.common.config import reduced as jreduced
from repro.configs import get_arch as jget_arch
from repro.launch.mesh import make_mesh
from repro.models import dit as JD
from repro.models import transformer as JT
from repro.models import vit as JV
from repro.train import optimizer as jopt
from repro_torch.common.config import (DIT_SHAPES, LM_SHAPES, VISION_SHAPES,
                                       reduced)
from repro_torch.configs import ARCH_IDS, get_arch, get_shapes
from repro_torch.hopper import ops
from repro_torch.launch import steps as ST
from repro_torch.models import dit as D
from repro_torch.models import efficientnet as E
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import vit as V
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import param_leaves
from test_torch_hopper_cuda import _margin

ATOL = 1e-5
_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.int32: jnp.int32, torch.uint32: jnp.uint32}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


def _leaves(tree):
    """A tree's leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _overrides(cfg):
    """The fields ``reduced`` changes, as ``cfg_overrides``."""
    red = reduced(cfg)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(cfg, f.name)}


# ---------------------------------------------------------------------------
# spec metadata
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_metadata_matches_jax(arch, mesh):
    over = _overrides(get_arch(arch))
    for name, cell in get_shapes(arch).items():
        for variant in ((None, "window") if cell.kind == "long" else (None,)):
            spec = ST.build(arch, name, variant=variant, cfg_overrides=over)
            jspec = JST.build(arch, name, mesh, variant=variant,
                              cfg_overrides=over)
            assert (spec.name, spec.skip_reason, spec.donate_argnums) == (
                jspec.name, jspec.skip_reason, jspec.donate_argnums)
            assert (spec.fn is None) == (jspec.fn is None)
            got, want = _leaves(spec.args), jax.tree.leaves(jspec.args)
            assert len(got) == len(want), spec.name
            for a, b in zip(got, want):
                if isinstance(a, int):
                    assert (b.shape, b.dtype) == ((), jnp.int32), spec.name
                else:
                    assert a.is_meta, spec.name
                    assert (tuple(a.shape), _DT[a.dtype]) == (
                        b.shape, b.dtype), spec.name


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _close_leaves(got, want, what, ulps=None, scale=None, floor=0.0,
                  atol=ATOL):
    """Each leaf within ``atol`` of its largest |value| (of ``scale`` where
    it is given) or ``floor``, whichever is larger; with ``ulps``, an
    element may also be off by that share of its own value."""
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g = g.detach().float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, what
        tol = max(atol * (scale if scale is not None
                          else max(np.abs(w).max(), 1e-30)), floor)
        if ulps:
            tol = tol + ulps * np.abs(w)
        assert np.all(np.abs(g - w) <= tol), (
            what, float(np.abs(g - w).max()), float(np.abs(w).max()))


def _check_train(out, jout, jparams_of, p0, ulps=None, noise=()):
    """``out`` = the port's (params, ..., opt_state, loss), ``jout`` JAX's;
    ``jparams_of`` reads the parameters back as a JAX tree, ``p0`` holds
    both packages' parameters before the step (JAX's leaf order). A
    parameter may also be off by a tenth of the step's learning rate, as
    ``tests/test_torch_train_lm.py`` allows: AdamW divides each moment by
    its root mean square, so an element whose gradient is near its
    ``eps`` moves by a share of the learning rate that rounding shifts (a
    zero-initialised bias's leaf is no larger than the learning rate).
    The step's change of each parameter is also held on its own scale:
    within ATOL of its leaf's largest |change| in JAX, one fp32 ulp of
    the new value (the rounding of the stored sum) and the tenth of the
    learning rate; a whole AdamW step at the warm-up's first learning
    rate is far smaller than ATOL of a weight, so only this catches an
    update of the wrong sign or size.
    Leaves whose path ends with ``noise`` have a zero gradient in exact
    arithmetic, so both packages' hold rounding noise there: their ``m``
    and ``v`` are held to ATOL of the model's largest, and AdamW, which
    divides by the noise's own size, moves each such parameter by up to
    the learning rate either way: held to 2 lr."""
    *_, l = out
    *_, jl = jout
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(jout[0])]
    is_noise = [p.endswith(noise) if noise else False for p in paths]
    pairs = {"params": ([torch.from_numpy(x) for x in
                         jax.tree.leaves(jparams_of(out[0]))],
                        jax.tree.leaves(jout[0]), None)}
    o, jo = out[-2], jout[-2]
    assert o["step"] == int(jo["step"]) == 1
    pairs["m"] = (o["m"], jax.tree.leaves(jo["m"]), ulps)
    pairs["v"] = (o["v"], jax.tree.leaves(jo["v"]), ulps and 2 * ulps)
    lr = opt.lr_at(ST.OPT_CFG, 0)
    for what, (got, want, u) in pairs.items():
        top = max(float(np.abs(np.asarray(w)).max()) for w in want)
        for n, g, w in zip(is_noise, got, want):
            if not n:
                _close_leaves([g], [w], what, u,
                              floor=lr / 10 if what == "params" else 0.0,
                              atol=2 * ATOL if what == "v" else ATOL)
            elif what == "params":
                assert np.abs(g.numpy() - np.asarray(w)).max() <= 2 * lr
            else:
                _close_leaves([g], [w], what, scale=top)
    assert any(is_noise) == bool(noise)
    assert len(p0) == len(pairs["params"][1])
    for n, g, w, z in zip(is_noise, *pairs["params"][:2], p0):
        if n:
            continue
        z = np.asarray(z, np.float64)
        w32 = np.asarray(w, np.float32)
        change, jchange = g.numpy().astype(np.float64) - z, w32 - z
        tol = (ATOL * np.abs(jchange).max() + lr / 10
               + np.spacing(np.abs(w32)))
        assert np.all(np.abs(change - jchange) <= tol), (
            "parameter change", float(np.abs(change - jchange).max()),
            float(np.abs(jchange).max()))


def _lm_batch(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _torch_tree(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("arch,over,ulps", [
    ("olmo-1b", {}, None),
    ("olmo-1b", {"train_microbatches": 2, "grad_reduce_dtype": "bf16"},
     2.0 ** -7),
    ("moonshot-v1-16b-a3b", {}, None),
], ids=["olmo", "olmo-mb2-bf16-reduce", "moonshot"])
def test_lm_train_step_matches_jax(arch, over, ulps, mesh, monkeypatch):
    cfg = reduced(get_arch(arch), dtype="float32", **over)
    jcfg = jreduced(jget_arch(arch), dtype="float32", **over)
    cell = dataclasses.replace(LM_SHAPES["train_4k"], seq_len=16,
                               global_batch=4)
    jp = jax.jit(lambda: JT.init(jax.random.PRNGKey(0), jcfg))()
    batch = _lm_batch(cfg, 4, 16, seed=1)
    jout = jax.jit(JST.build_lm(jcfg, cell, mesh).fn)(
        jp, jopt.init(jp), batch)

    routed = []
    route = L.moe_route

    def recording(gate, xg, top_k, capacity):
        out = route(gate, xg, top_k, capacity)
        routed.append(_margin(out[0].detach(), top_k))
        return out
    monkeypatch.setattr(L, "moe_route", recording)
    params = T.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    spec = ST.build_lm(cfg, cell)
    out = spec.fn(params, opt.init(param_leaves(params)), _torch_tree(batch))
    assert out[0] is params                 # updated in place
    if cfg.moe:
        assert len(routed) == cfg.n_layers * cfg.train_microbatches == 8
        assert min(routed) >= 1e-4, f"a near-tie in the inputs: {routed}"
    _check_train(out, jout, T.params_to_jax, _copies(jp), ulps)


@pytest.fixture(scope="module")
def dit_s2():
    """Reduced dit-s2 in fp32 and JAX's weights, drawn once for both DiT
    steps (each test carries them to fresh port tensors)."""
    cfg = reduced(get_arch("dit-s2"), dtype="float32")
    jcfg = jreduced(jget_arch("dit-s2"), dtype="float32")
    return cfg, jcfg, jax.jit(lambda: JD.init(jax.random.PRNGKey(0), jcfg))()


def _copies(jtree):
    """A tree's leaves as numpy copies, in JAX's order."""
    return [np.array(x) for x in jax.tree.leaves(jtree)]


def test_dit_train_step_matches_jax(dit_s2, mesh):
    cfg, jcfg, jp = dit_s2
    cell = dataclasses.replace(DIT_SHAPES["train_256"], img_res=32,
                               global_batch=2)
    r = np.random.default_rng(2)
    batch = {"latents": r.normal(size=(2, 4, 4, 4)).astype(np.float32),
             "labels": np.array([3, 11], np.int32)}
    seed = np.array([0, 7], np.uint32)
    jout = jax.jit(JST.build_dit(jcfg, cell, mesh).fn)(
        jp, jopt.init(jp), batch, seed)
    params = D.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    out = ST.build_dit(cfg, cell).fn(params, opt.init(param_leaves(params)),
                                     _torch_tree(batch),
                                     torch.from_numpy(seed))
    _check_train(out, jout, D.params_to_jax, _copies(jp))


def _images(B, R, seed):
    return np.random.default_rng(seed).normal(size=(B, R, R, 3)).astype(
        np.float32)


def test_vit_train_step_matches_jax(mesh):
    cfg = reduced(get_arch("vit-s16"), dtype="float32")
    jcfg = jreduced(jget_arch("vit-s16"), dtype="float32")
    cell = dataclasses.replace(VISION_SHAPES["cls_224"], img_res=32,
                               global_batch=2)
    jp = jax.jit(lambda: JV.init(jax.random.PRNGKey(0), jcfg))()
    batch = {"images": _images(2, 32, 3), "labels": np.array([1, 9],
                                                             np.int32)}
    jout = jax.jit(JST.build_vit(jcfg, cell, mesh).fn)(
        jp, jopt.init(jp), batch)
    params = V.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    out = ST.build_vit(cfg, cell).fn(params, opt.init(param_leaves(params)),
                                     _torch_tree(batch))
    _check_train(out, jout, V.params_to_jax, _copies(jp))


@pytest.fixture(scope="module")
def effnet_draw():
    """The port's draw of reduced efficientnet-b7 (fp32), made once; each
    call hands out fresh copies."""
    drawn = {}

    def draw(cfg):
        if "tree" not in drawn:
            drawn["tree"] = E.init(cfg, seed=0, device="cpu")
        return L.tree_map(torch.clone, drawn["tree"])
    return draw


def test_effnet_train_step_matches_jax(effnet_draw, mesh):
    """At 64 px and batch 4: the head's batch norm over 16 values a channel
    (ROADMAP C15), as ``tests/test_torch_vision.py`` holds it. Every
    ``project`` batch norm's bias has a zero gradient in exact arithmetic
    (the next batch norm in training mode takes the batch mean out), as
    ``tests/test_torch_vision.py`` shows."""
    cfg = reduced(get_arch("efficientnet-b7"), dtype="float32")
    jcfg = jreduced(jget_arch("efficientnet-b7"), dtype="float32")
    cell = dataclasses.replace(VISION_SHAPES["cls_224"], img_res=64,
                               global_batch=4)
    params, state = effnet_draw(cfg)
    jp, js = E.params_to_jax(params, state)
    p0 = _copies(jp)        # the port's step updates params in place
    batch = {"images": _images(4, 64, 4),
             "labels": np.array([2, 5, 9, 1], np.int32)}
    jout = jax.jit(JST.build_effnet(jcfg, cell, mesh).fn)(
        jp, js, jopt.init(jp), batch)
    out = ST.build_effnet(cfg, cell).fn(
        params, state, opt.init(param_leaves(params)), _torch_tree(batch))
    _check_train(out, jout, lambda p: E.params_to_jax(p, state)[0], p0,
                 noise="['project']['bn']['bias']")
    for a, b in zip(_leaves(out[1]), jax.tree.leaves(jout[1])):
        # the state's tolerance in ``tests/test_torch_vision.py``
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    assert not any(t.requires_grad for t in _leaves(out[1]))


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module")
def olmo():
    cfg = reduced(get_arch("olmo-1b"), dtype="float32")
    jcfg = jreduced(jget_arch("olmo-1b"), dtype="float32")
    jp = jax.jit(lambda: JT.init(jax.random.PRNGKey(0), jcfg))()
    return cfg, jcfg, jp, T.params_from_jax(jax.tree.map(np.asarray, jp),
                                            cfg, "cpu")


def test_prefill_step_matches_jax_and_chunks_bitwise(olmo, mesh):
    cfg, jcfg, jp, params = olmo
    cell = dataclasses.replace(LM_SHAPES["prefill_32k"], seq_len=16,
                               global_batch=4)
    tokens = _lm_batch(cfg, 4, 16, seed=5)["tokens"]
    want = jax.jit(JST.build_lm(jcfg, cell, mesh).fn)(jp, tokens)
    got = ST.build_lm(cfg, cell).fn(params, torch.from_numpy(tokens))
    assert got.shape == (4, 1, cfg.vocab_size)
    assert _rel(got, want) <= ATOL
    two = dataclasses.replace(cfg, prefill_batch_chunks=2)
    chunked = ST.build_lm(two, cell).fn(params, torch.from_numpy(tokens))
    assert torch.equal(chunked, got)
    jtwo = dataclasses.replace(jcfg, prefill_batch_chunks=2)
    want2 = jax.jit(JST.build_lm(jtwo, cell, mesh).fn)(jp, tokens)
    assert _rel(chunked, want2) <= ATOL


def test_long_prefill_recipe(monkeypatch):
    """granite-34b's prefill_32k (d_model 6144, S = 32768) runs in two
    halves of the batch with 1024-row query blocks, as JAX's recipe does;
    traced on meta tensors at one layer."""
    calls = []

    def prefill(params, tokens, cfg, attn_impl="einsum", mesh=None):
        calls.append((tuple(tokens.shape), cfg.attn_q_chunk,
                      cfg.act_sharding, attn_impl))
        return torch.empty((tokens.shape[0], 1, cfg.vocab_size),
                           device="meta")
    monkeypatch.setattr(T, "prefill", prefill)
    spec = ST.build("granite-34b", "prefill_32k",
                    cfg_overrides={"n_layers": 1})
    out = spec.fn(*spec.args)
    assert out.shape == (32, 1, 49152)
    assert calls == [((16, 32768), 1024, "dp", "einsum")] * 2
    calls.clear()
    spec = ST.build("olmo-1b", "prefill_32k", cfg_overrides={"n_layers": 1})
    spec.fn(*spec.args)
    assert calls == [((32, 32768), 4096, "auto", "einsum")]


def _decode_both(cfg, jcfg, jp, params, spec, jfn, n_steps, seed):
    """``n_steps`` tokens fed through both decode steps from empty caches:
    the largest relative logit difference and the final caches."""
    B = spec.args[2].shape[0]
    cache = T.init_cache(cfg, B, spec.args[1]["k"].shape[2], device="cpu")
    jcache = JT.init_cache(jcfg, B, spec.args[1]["k"].shape[2])
    toks = _lm_batch(cfg, B, n_steps, seed)["tokens"]
    worst = 0.0
    for t in range(n_steps):
        tok = toks[:, t:t + 1]
        logits, cache = spec.fn(params, cache, torch.from_numpy(tok), t)
        jlogits, jcache = jfn(jp, jcache, tok, jnp.int32(t))
        worst = max(worst, _rel(logits, jlogits))
    return worst, cache, jcache


def test_decode_step_matches_jax(olmo, mesh):
    cfg, jcfg, jp, params = olmo
    cell = dataclasses.replace(LM_SHAPES["decode_32k"], seq_len=16,
                               global_batch=2)
    spec = ST.build_lm(cfg, cell)
    worst, cache, jcache = _decode_both(
        cfg, jcfg, jp, params, spec,
        jax.jit(JST.build_lm(jcfg, cell, mesh).fn), 6, seed=6)
    assert worst <= ATOL
    for k in ("k", "v"):
        _close_leaves([cache[k]], [jcache[k]], k)


def test_window_decode_step_matches_jax(olmo, mesh):
    """The long cell's window variant, window 4, fed 9 tokens: the
    window masks the first slots by the last steps."""
    cfg, jcfg, jp, params = olmo
    cell = dataclasses.replace(LM_SHAPES["long_500k"], seq_len=16)
    assert ST.build_lm(cfg, cell).skip_reason is not None
    spec = ST.build_lm_long_window(cfg, cell, window=4)
    jspec = JST.build_lm_long_window(jcfg, cell, mesh, window=4)
    assert spec.name == jspec.name == "olmo-1b-smoke:long_500k:window4"
    worst, _, _ = _decode_both(cfg, jcfg, jp, params, spec,
                               jax.jit(jspec.fn), 9, seed=7)
    assert worst <= ATOL


def test_dit_sample_step_matches_jax(dit_s2, mesh):
    cfg, jcfg, jp = dit_s2
    cell = dataclasses.replace(DIT_SHAPES["gen_fast"], img_res=32,
                               global_batch=2, steps=2)
    labels, seed = np.array([4, 13], np.int32), np.array([0, 9], np.uint32)
    want = jax.jit(JST.build_dit(jcfg, cell, mesh).fn)(jp, labels, seed)
    params = D.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    got = ST.build_dit(cfg, cell).fn(params, torch.from_numpy(labels),
                                     torch.from_numpy(seed))
    assert got.shape == (2, 4, 4, cfg.latent_channels)
    assert _rel(got, want) <= ATOL


def test_vision_serve_steps_match_jax(effnet_draw, mesh):
    cfg = reduced(get_arch("deit-b"), dtype="float32", serve_pure_dp=True)
    jcfg = jreduced(jget_arch("deit-b"), dtype="float32", serve_pure_dp=True)
    cell = dataclasses.replace(VISION_SHAPES["serve_b128"], img_res=32,
                               global_batch=3)
    jp = jax.jit(lambda: JV.init(jax.random.PRNGKey(0), jcfg))()
    x = _images(3, 32, 8)
    want = jax.jit(JST.build_vit(jcfg, cell, mesh).fn)(jp, x)
    got = ST.build_vit(cfg, cell).fn(
        V.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu"),
        torch.from_numpy(x))
    assert got.shape == (3, cfg.n_classes) and _rel(got, want) <= ATOL

    ecfg = reduced(get_arch("efficientnet-b7"), dtype="float32")
    jecfg = jreduced(jget_arch("efficientnet-b7"), dtype="float32")
    cell = dataclasses.replace(cell, img_res=64, global_batch=2)
    params, state = effnet_draw(ecfg)
    x = _images(2, 64, 9)
    want = jax.jit(JST.build_effnet(jecfg, cell, mesh).fn)(
        *E.params_to_jax(params, state), x)
    got = ST.build_effnet(ecfg, cell).fn(params, state, torch.from_numpy(x))
    assert got.shape == (2, ecfg.n_classes) and _rel(got, want) <= ATOL


# ---------------------------------------------------------------------------
# the serve route
# ---------------------------------------------------------------------------

class _OnTheCard:
    """Stands in for activations on the card: the route reads only
    ``is_cuda``."""
    is_cuda = True


def test_serve_route_choice():
    x = torch.zeros(2, 8, 64)
    card = _OnTheCard()
    assert L.serve_attn_impl(x, 128) == "einsum"            # CPU tensors
    assert L.serve_attn_impl(card, 128) == "flash"
    for dh in ops.FLASH_HEAD_DIMS:
        assert L.serve_attn_impl(card, dh) == "flash"
    assert L.serve_attn_impl(card, 128, window=8192) == "einsum"
    assert L.serve_attn_impl(card, 128, causal=False) == "einsum"
    assert L.serve_attn_impl(card, 48) == "einsum"          # not built
    assert L.serve_attn_impl(card, 256) == "einsum"
