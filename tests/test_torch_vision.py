"""The vision models of the port (ViT, DeiT, EfficientNet) and their layer
primitives against the JAX package, on reduced configs and the same
seeded numpy inputs, on the CPU.

- ``init``: every leaf bitwise JAX's (threefry), for each arch id, with
  the leaf dtypes of JAX's ``init`` (norm and batch-norm leaves fp32).
- ``conv`` with ``"SAME"`` padding (asymmetric at stride 2, as XLA pads),
  for strides 1 and 2, kernels 1, 3 and 5, even and odd sizes, dense and
  depthwise, and ``"VALID"``: within 1e-5 of the largest |out| (fp32
  sums in another order). No other padding form is taken.
- ``batchnorm``: output and new state in train and eval within 1e-5;
  ``squeeze_excite`` and ``patch_embed`` likewise.
- ``_interp_pos`` up (14 -> 24, the cls_384 cell) and down (24 -> 14):
  within 1e-5 (``jax.image.resize`` antialiases when it shrinks).
- fp32 forward: ViT logits and ``features_only``, DeiT (two heads), at
  the config's resolution and at others (pos table resized), and
  EfficientNet's logits and batch-norm state in eval and train: within
  1e-5 of the largest |out|. First-step gradients against ``jax.grad``,
  within 1e-5 of each leaf's largest |grad|.
- bf16: ViT and DeiT logits within 2e-2 of the largest |logit| (as the
  LM, ROADMAP C9). EfficientNet in bf16 is held to JAX's fp32 logits:
  its distance at most 1.5 times JAX's own bf16 model's (ROADMAP C15: a
  batch norm over a few values per channel magnifies bf16 rounding, so
  two bf16 EfficientNets part by more than 2e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.common.config import reduced as jreduced
from repro.configs import get_arch as jget_arch
from repro.models import efficientnet as JE
from repro.models import layers as JL
from repro.models import vit as JV
from repro_torch.common import prng
from repro_torch.common.config import VISION_SHAPES, reduced
from repro_torch.configs import get_arch
from repro_torch.models import efficientnet as E
from repro_torch.models import layers as L
from repro_torch.models import vit as V
from repro_torch.train.checkpoint import flatten


def _cfgs(arch, **kw):
    return reduced(get_arch(arch), **kw), jreduced(jget_arch(arch), **kw)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _images(B, res, seed):
    return np.random.default_rng(seed).normal(
        size=(B, res, res, 3)).astype(np.float32)


# one compile per (config, mode, shapes), shared by the tests below
_jeff_forward = jax.jit(
    lambda q, st, im, cfg, train: JE.forward(q, st, im, cfg, train=train),
    static_argnums=(3, 4))


def _cast_like_init(tree, dtype):
    """A fp32 JAX tree as numpy leaves, each in the dtype that ``init`` in
    ``dtype`` gives it (batch-norm ``scale``/``bias`` stay fp32). numpy's
    cast rounds as JAX's does, without a compile per leaf shape."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) if path[-1].key in ("scale", "bias")
        else np.asarray(a).astype(dtype), tree)


def _assert_leaves_equal(port_tree, jax_tree):
    got = [x.float().numpy() if isinstance(x, torch.Tensor) else x
           for x in flatten(port_tree)[0]]
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(jax_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["vit-l16", "vit-s16", "deit-b",
                                  "efficientnet-b7"])
def test_vision_configs_equal_jax(arch):
    import dataclasses
    from repro.common.config import VISION_SHAPES as JVS
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params()
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(
        jreduced(jcfg))
    assert {k: dataclasses.asdict(v) for k, v in VISION_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JVS.items()}


def test_full_width_parameter_counts():
    counts = {a: get_arch(a).n_params() for a in
              ("vit-l16", "vit-s16", "deit-b", "efficientnet-b7")}
    assert counts == {"vit-l16": 304104424, "vit-s16": 22008808,
                      "deit-b": 87253712, "efficientnet-b7": 66347960}
    assert get_arch("vit-l16").n_tokens() == 197
    assert get_arch("deit-b").n_tokens() == 198
    assert len(E.block_specs(get_arch("efficientnet-b7"))) == 55


@pytest.mark.parametrize("arch", ["vit-l16", "deit-b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_init_is_jax_bitwise(arch, dtype):
    cfg, jcfg = _cfgs(arch, dtype=dtype)
    jp = JV.init(jax.random.PRNGKey(0), jcfg)
    p = V.init(cfg, 0, "cpu")
    _assert_leaves_equal(V.params_to_jax(p), jp)
    fp32 = {"scale", "bias"}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = p
        for k in path:
            t = t[k.key]
        assert t.dtype == (torch.float32 if path[-1].key in fp32
                           else L.compute_dtype(dtype))
        assert str(leaf.dtype) == str(t.dtype).replace("torch.", "")
    back = V.params_from_jax(_np(jp), cfg, "cpu")
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
               zip(flatten(back)[0], flatten(p)[0]))


@pytest.fixture(scope="module")
def effnet():
    """Reduced efficientnet-b7 in fp32: JAX's eager init (the reference's
    own draw) and the port's."""
    cfg, jcfg = _cfgs("efficientnet-b7", dtype="float32")
    jp, js = JE.init(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, jp, js, E.init(cfg, 0, "cpu")


def test_effnet_init_is_jax_bitwise(effnet):
    cfg, jcfg, jp, js, (p, s) = effnet
    a, b = E.params_to_jax(p, s)
    _assert_leaves_equal(a, jp)
    _assert_leaves_equal(b, js)
    assert E.count_params(cfg) == JE.count_params(jcfg) == \
        sum(x.numel() for x in flatten(p)[0])
    assert E.flops_per_image(cfg) == JE.flops_per_image(jcfg)
    full = get_arch("efficientnet-b7")
    assert E.flops_per_image(full) == JE.flops_per_image(
        jget_arch("efficientnet-b7")) == 71031622656
    bf = reduced(get_arch("efficientnet-b7"))
    pb, sb = E.params_from_jax(_np(jp), _np(js), bf, "cpu")
    assert pb["stem"]["conv"]["w"].dtype == torch.bfloat16
    assert pb["stem"]["bn"]["scale"].dtype == torch.float32
    assert pb["blocks"][0]["bn_dw"]["bias"].dtype == torch.float32
    assert sb["blocks"][0]["dw"]["var"].dtype == torch.float32


# ---------------------------------------------------------------------------
# layer primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [8, 9, 15])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("depthwise", [False, True], ids=["dense", "dw"])
def test_conv_same_padding_matches_jax(size, k, stride, depthwise):
    r = np.random.default_rng(size * 100 + k * 10 + stride)
    cin = 6
    cout, groups = (cin, cin) if depthwise else (4, 1)
    x = r.normal(size=(2, size, size, cin)).astype(np.float32)
    w = r.normal(size=(k, k, cin // groups, cout)).astype(np.float32)
    want = np.asarray(JL.conv({"w": jnp.asarray(w)}, jnp.asarray(x),
                              stride=stride, groups=groups))
    got = L.conv({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                 stride=stride, groups=groups).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_same_pads_are_xla_s():
    assert L.same_pads(8, 3, 2) == (0, 1)          # F.conv2d(padding=1): 1/1
    assert L.same_pads(600, 3, 2) == (0, 1)        # b7's stem
    assert L.same_pads(150, 5, 2) == (1, 2)
    assert L.same_pads(9, 3, 2) == (1, 1)
    assert L.same_pads(7, 5, 1) == (2, 2)


def test_conv_valid_matches_jax():
    r = np.random.default_rng(4)
    x = r.normal(size=(2, 9, 10, 3)).astype(np.float32)
    w = r.normal(size=(3, 3, 3, 5)).astype(np.float32)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = L.conv({"w": torch.from_numpy(w)}, torch.from_numpy(x), stride=2,
                 padding="VALID").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_conv_takes_only_same_and_valid():
    """The models pad SAME (EfficientNet) or VALID (the patch embedding);
    explicit pads are not a form of the port's ``conv``."""
    x, w = torch.zeros(1, 4, 4, 2), torch.zeros(3, 3, 2, 2)
    with pytest.raises(ValueError, match="padding"):
        L.conv({"w": w}, x, padding=((1, 1), (1, 1)))


def test_patch_embed_and_inits_match_jax():
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 16, 24, 3)).astype(np.float32)
    jp = JL.patch_embed_init(jax.random.PRNGKey(3), 8, 3, 32, jnp.float32)
    p = L.patch_embed_init(prng.key(3), 8, 3, 32, torch.float32)
    _assert_leaves_equal(p, jp)
    p["b"] = torch.from_numpy(r.normal(size=32).astype(np.float32))
    want = np.asarray(JL.patch_embed(dict(jp, b=jnp.asarray(p["b"].numpy())),
                                     jnp.asarray(x), 8))
    got = L.patch_embed(p, torch.from_numpy(x), 8).numpy()
    assert got.shape == want.shape == (2, 6, 32)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    _assert_leaves_equal(
        L.conv_init(prng.key(9), 5, 5, 12, 12, torch.float32,
                    groups=12),
        JL.conv_init(jax.random.PRNGKey(9), 5, 5, 12, 12, jnp.float32,
                     groups=12))
    _assert_leaves_equal(L.se_init(prng.key(2), 12, 3,
                                   torch.bfloat16),
                         JL.se_init(jax.random.PRNGKey(2), 12, 3,
                                    jnp.bfloat16))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_and_state_match_jax(train):
    r = np.random.default_rng(6)
    x = (r.normal(size=(4, 5, 7, 8)) * 3 + 1).astype(np.float32)
    params = {"scale": r.normal(size=8).astype(np.float32),
              "bias": r.normal(size=8).astype(np.float32)}
    state = {"mean": r.normal(size=8).astype(np.float32),
             "var": r.uniform(0.5, 2, size=8).astype(np.float32)}
    jy, jst = JL.batchnorm(jax.tree.map(jnp.asarray, params),
                           jax.tree.map(jnp.asarray, state),
                           jnp.asarray(x), train)
    tt = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = {k: torch.from_numpy(v) for k, v in state.items()}
    y, st = L.batchnorm(tt, ts, torch.from_numpy(x), train)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                               atol=1e-5 * np.abs(np.asarray(jy)).max())
    for k in ("mean", "var"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-6, atol=1e-6)
    if not train:
        assert st is ts
    else:       # the biased variance and 0.99 momentum: not BatchNorm2d's
        assert not np.allclose(st["var"].numpy(), 0.9 * state["var"]
                               + 0.1 * x.var((0, 1, 2), ddof=1))
    jl = JL.bn_init(8)
    _assert_leaves_equal(L.bn_init(8), jl)


def test_squeeze_excite_matches_jax():
    r = np.random.default_rng(7)
    x = r.normal(size=(3, 5, 5, 12)).astype(np.float32)
    jp = _np(JL.se_init(jax.random.PRNGKey(1), 12, 3, jnp.float32))
    jp["b1"] = r.normal(size=3).astype(np.float32)
    want = np.asarray(JL.squeeze_excite(jax.tree.map(jnp.asarray, jp),
                                        jnp.asarray(x)))
    got = L.squeeze_excite({k: torch.from_numpy(v) for k, v in jp.items()},
                           torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("g_old,g_new", [(14, 24), (4, 6), (24, 14),
                                         (6, 4)])
def test_interp_pos_matches_jax_up_and_down(g_old, g_new):
    r = np.random.default_rng(g_old * g_new)
    pos = r.normal(size=(1, 2 + g_old * g_old, 16)).astype(np.float32)
    want = np.asarray(JV._interp_pos(jnp.asarray(pos), 2, g_new * g_new))
    got = V._interp_pos(torch.from_numpy(pos), 2, g_new * g_new).numpy()
    assert got.shape == want.shape == (1, 2 + g_new * g_new, 16)
    np.testing.assert_array_equal(got[:, :2], pos[:, :2])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# ViT / DeiT forward, bf16 and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["vit-s16", "deit-b"])
@pytest.mark.parametrize("res", [32, 48, 16])
def test_vit_forward_fp32_matches_jax(arch, res):
    cfg, jcfg = _cfgs(arch, dtype="float32")
    jp = JV.init(jax.random.PRNGKey(1), jcfg)
    p = V.params_from_jax(_np(jp), cfg, "cpu")
    x = _images(3, res, res)
    fwd = jax.jit(lambda q, im: (JV.forward(q, im, jcfg),
                                 JV.forward(q, im, jcfg,
                                            features_only=True)))
    jl, jf = fwd(jp, jnp.asarray(x))
    with torch.no_grad():
        logits = V.forward(p, torch.from_numpy(x), cfg)
        feats = V.forward(p, torch.from_numpy(x), cfg, features_only=True)
    assert logits.dtype == feats.dtype == torch.float32
    assert tuple(logits.shape) == (3, cfg.n_classes)
    assert tuple(feats.shape) == (3, cfg.d_model)
    assert _rel(logits, jl) <= 1e-5 and _rel(feats, jf) <= 1e-5


@pytest.mark.parametrize("arch", ["vit-s16", "deit-b"])
def test_vit_forward_bf16_within_2e2(arch):
    cfg, jcfg = _cfgs(arch)
    assert cfg.dtype == "bfloat16"
    jp = JV.init(jax.random.PRNGKey(2), jcfg)
    p = V.params_from_jax(_np(jp), cfg, "cpu")
    x = _images(4, 32, 9)
    jl = jax.jit(lambda q, im: JV.forward(q, im, jcfg))(jp, jnp.asarray(x))
    with torch.no_grad():
        logits = V.forward(p, torch.from_numpy(x), cfg)
    assert logits.dtype == torch.float32
    assert _rel(logits, jl) <= 2e-2


def _port_grads(loss, leaves):
    for t in leaves:
        t.requires_grad_(True)
    g = torch.autograd.grad(loss(), leaves)
    for t in leaves:
        t.requires_grad_(False)
    return g


def _assert_grads_match(grads, jgrads):
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jgrads)]
    assert len(grads) == len(jleaves)
    for g, j in zip(grads, jleaves):
        assert g.shape == j.shape
        np.testing.assert_allclose(g.numpy(), j, rtol=0,
                                   atol=1e-5 * max(np.abs(j).max(), 1e-30))


@pytest.mark.parametrize("arch,remat", [("vit-s16", False),
                                        ("deit-b", True)])
def test_vit_first_step_grads_match_jax(arch, remat):
    cfg, jcfg = _cfgs(arch, dtype="float32", remat=remat)
    jp = _np(JV.init(jax.random.PRNGKey(3), jcfg))
    x, y = _images(4, 32, 11), np.array([0, 3, 7, 15])
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda q: JV.loss_fn(q, jnp.asarray(x), jnp.asarray(y), jcfg),
        has_aux=True))(jp)
    p = V.params_from_jax(jp, cfg, "cpu")
    leaves = flatten(p)[0]
    out = {}

    def loss():
        loss, out["m"] = V.loss_fn(p, torch.from_numpy(x),
                                   torch.from_numpy(y), cfg)
        out["loss"] = loss.detach()
        return loss

    _assert_grads_match(_port_grads(loss, leaves), jg)
    np.testing.assert_allclose(float(out["loss"]), float(jl), rtol=1e-6)
    assert set(out["m"]) == {"nll", "acc"}


# ---------------------------------------------------------------------------
# EfficientNet forward, state, bf16 and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res", [32, 37])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_effnet_forward_and_state_fp32_match_jax(effnet, res, train):
    cfg, jcfg, jp, js, _ = effnet
    p, s = E.params_from_jax(_np(jp), _np(js), cfg, "cpu")
    x = _images(4, res, res)
    jl, jst = _jeff_forward(jp, js, jnp.asarray(x), jcfg, train)
    with torch.no_grad():
        logits, st = E.forward(p, s, torch.from_numpy(x), cfg, train=train)
        feats, _ = E.forward(p, s, torch.from_numpy(x), cfg, train=train,
                             features_only=True)
    assert logits.dtype == torch.float32 and _rel(logits, jl) <= 1e-5
    assert tuple(feats.shape) == (4, 1280)
    got, want = flatten(L.tree_to_jax(st))[0], jax.tree.leaves(jst)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    if not train:
        assert all(a is b for a, b in zip(flatten(st)[0], flatten(s)[0]))


def test_effnet_bf16_as_close_to_fp32_as_jax_bf16(effnet):
    cfg, jcfg, jp, js, _ = effnet
    bcfg, jbcfg = _cfgs("efficientnet-b7")
    jpb = _cast_like_init(jp, jnp.bfloat16)      # JAX's bf16 init, leafwise
    jpr = jax.tree.map(lambda a: a.astype(np.float32), jpb)
    pb, sb = E.params_from_jax(_np(jpb), _np(js), bcfg, "cpu")
    x = _images(4, 32, 32)
    ref = np.asarray(_jeff_forward(jpr, js, jnp.asarray(x), jcfg, False)[0])
    jb = np.asarray(_jeff_forward(jpb, js, jnp.asarray(x), jbcfg, False)[0])
    with torch.no_grad():
        got = E.forward(pb, sb, torch.from_numpy(x), bcfg)[0]
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= 1.5 * _rel(jb, ref)


def test_effnet_first_step_grads_match_jax(effnet):
    """At 64 px: at the reduced config's 32 px the head's batch norm
    normalises 4 values a channel (1 x 1 x B), which magnifies rounding
    in both packages (fc/w measured 1.75e-4 of its largest |grad| apart).
    Every ``project`` batch norm's bias has a zero gradient in exact
    arithmetic (the next batch norm in training mode takes the batch mean
    out of the shift it adds): those leaves hold rounding noise in both
    packages, held to 1e-5 of the largest |grad| of the model."""
    cfg, jcfg, jp, js, _ = effnet
    x, y = _images(4, 64, 17), np.array([1, 5, 9, 2])
    (jl, (_, jst)), jg = jax.jit(jax.value_and_grad(
        lambda q: JE.loss_fn(q, js, jnp.asarray(x), jnp.asarray(y), jcfg),
        has_aux=True))(jp)
    p, s = E.params_from_jax(_np(jp), _np(js), cfg, "cpu")
    out = {}

    def loss():
        loss, (out["m"], out["state"]) = E.loss_fn(
            p, s, torch.from_numpy(x), torch.from_numpy(y), cfg)
        out["loss"] = loss.detach()
        return loss

    grads = _port_grads(loss, flatten(p)[0])
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_leaves_with_path(jg)]
    jleaves = [np.asarray(g) for g in jax.tree.leaves(jg)]
    top = max(float(np.abs(j).max()) for j in jleaves)
    n_zero = 0
    for path, g, j in zip(paths, grads, jleaves):
        if path.endswith("['project']['bn']['bias']"):
            n_zero += 1
            assert max(np.abs(j).max(), g.abs().max()) <= 1e-5 * top
        else:
            np.testing.assert_allclose(g.numpy(), j, rtol=0,
                                       atol=1e-5 * np.abs(j).max())
    assert n_zero == len(E.block_specs(cfg))
    np.testing.assert_allclose(float(out["loss"]), float(jl), rtol=1e-5)
    for a, b in zip(flatten(L.tree_to_jax(out["state"]))[0],
                    jax.tree.leaves(jst)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
