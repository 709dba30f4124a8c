"""The port's decoder LM (``repro_torch.models.transformer``) against the
JAX package's ``repro.models.transformer``, on reduced ``olmo-1b``
(non-parametric LN, SwiGLU, tied embeddings) and reduced ``granite-34b``
(LayerNorm, GELU, grouped KV, a separate head), in fp32: the configs equal
field for field, ``init(cfg, seed)`` equal bit for bit (the same threefry
draw), and ``forward``/``prefill`` on both attention routes and a
``decode_step`` sequence equal to 1e-5 (fp32 sums in another order). The
JAX side's flash route runs its Pallas kernel in interpret mode. In bf16
the same weights give prefill (both routes), ``forward`` and 8
``decode_step``s within 2e-2 of JAX's bf16 LM's largest |logit|
(``_close_bf16`` says why)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import LM_SHAPES as J_LM_SHAPES
from repro.common.config import reduced as jreduced
from repro.configs import get_arch as jget_arch
from repro.models import transformer as JT
from repro_torch.common.config import LM_SHAPES, LMConfig, reduced
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import transformer as T

ATOL = 1e-5


def _cfgs(arch, **kw):
    return (reduced(get_arch(arch), dtype="float32", **kw),
            jreduced(jget_arch(arch), dtype="float32", **kw))


@pytest.fixture(scope="module", params=["olmo-1b", "granite-34b"])
def model(request):
    cfg, jcfg = _cfgs(request.param)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, T.params_from_jax(jp, cfg, "cpu"), jp


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-34b", "dbrx-132b",
                                  "moonshot-v1-16b-a3b"])
def test_configs_equal_jax_field_for_field(arch):
    assert dataclasses.asdict(get_arch(arch)) == \
        dataclasses.asdict(jget_arch(arch))
    cfg, jcfg = _cfgs(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.head_dim == jcfg.head_dim
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    assert {k: dataclasses.asdict(v) for k, v in LM_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_LM_SHAPES.items()}


def test_full_olmo_1b_parameter_count():
    cfg = get_arch("olmo-1b")
    assert cfg.n_params() == jget_arch("olmo-1b").n_params() == 1176766464
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (16, 2048, 16, 16, 128, 8192, 50304)
    assert ARCH_IDS == ["dbrx-132b", "moonshot-v1-16b-a3b", "olmo-1b",
                        "granite-34b", "dit-b2", "dit-s2", "vit-l16",
                        "deit-b", "efficientnet-b7", "vit-s16"]


def test_moe_counts_and_reduced_raise_outside_the_lm_family():
    moe = dataclasses.replace(get_arch("olmo-1b"), moe=True, n_experts=4,
                              moe_top_k=2)
    jmoe = dataclasses.replace(jget_arch("olmo-1b"), moe=True, n_experts=4,
                               moe_top_k=2)
    assert moe.n_params() == jmoe.n_params()
    assert moe.n_active_params() == jmoe.n_active_params()
    assert reduced(moe).n_experts == 4
    p = T.init(reduced(moe), 0, "cpu")          # MoE layers build
    assert set(p["layers"]) == {"ln1", "attn", "ln2", "moe"}
    assert p["layers"]["moe"]["wi"].shape == (2, 4, 64, 128)
    with pytest.raises(TypeError):
        reduced(object())
    for arch, n, active in (("dbrx-132b", 131596523520, 36469708800),
                            ("moonshot-v1-16b-a3b", 28057995264,
                             3974301696)):
        cfg = get_arch(arch)                    # the MoE ids build
        assert cfg.moe and (cfg.n_params(), cfg.n_active_params()) == \
            (n, active)
    with pytest.raises(KeyError):
        get_arch("vit-h14")


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-34b"])
@pytest.mark.parametrize("seed", [0, 1])
def test_init_equals_jax_init(arch, seed):
    cfg, jcfg = _cfgs(arch)
    got = T.params_to_jax(T.init(cfg, seed, "cpu"))
    want = JT.init(jax.random.PRNGKey(seed), jcfg)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_bf16_init_equals_jax_init():
    cfg = reduced(get_arch("granite-34b"))
    jcfg = jreduced(jget_arch("granite-34b"))
    p = T.init(cfg, 0, "cpu")
    assert p["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert p["layers"]["ln1"]["scale"].dtype == torch.float32
    want = JT.init(jax.random.PRNGKey(0), jcfg)
    for x, y in zip(jax.tree.leaves(T.params_to_jax(p)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, np.asarray(y, np.float32))


def test_params_round_trip(model):
    cfg, _, p, jp = model
    tree = T.params_to_jax(p)
    for x, y in zip(jax.tree.leaves(tree), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(x, np.asarray(y))
    back = T.params_from_jax(tree, cfg, "cpu")
    for x, y in zip(jax.tree.leaves(T.params_to_jax(back)),
                    jax.tree.leaves(tree)):
        np.testing.assert_array_equal(x, y)
    assert p["layers"]["attn"]["wq"].shape[0] == cfg.n_layers


def test_forward_matches_jax(model):
    cfg, jcfg, p, jp = model
    toks = _tokens(cfg, 2, 24, 0)
    logits, aux = T.forward(p, torch.from_numpy(toks).long(), cfg)
    jlogits, jaux = JT.forward(jp, jnp.asarray(toks), jcfg)
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 24, cfg.vocab_size)
    _close(logits, jlogits)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_prefill_matches_jax(model, attn_impl):
    """Both routes against the JAX package's prefill (its LM computes the
    einsum route)."""
    cfg, jcfg, p, jp = model
    toks = _tokens(cfg, 2, 37, 1)
    got = T.prefill(p, torch.from_numpy(toks).long(), cfg,
                    attn_impl=attn_impl)
    assert got.shape == (2, 1, cfg.vocab_size)
    _close(got, JT.prefill(jp, jnp.asarray(toks), jcfg))


def test_prefill_flash_route_matches_jax_flash_layer():
    """The flash route against the JAX package's own ``attn_impl="flash"``
    attention, layer by layer through a one-layer model."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    cfg, jcfg = _cfgs("olmo-1b", n_layers=1)
    jp = JT.init(jax.random.PRNGKey(3), jcfg)
    p = T.params_from_jax(jp, cfg, "cpu")
    x = np.random.default_rng(2).normal(size=(2, 20, 64)).astype(np.float32)
    ja = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    ta = {k: v[0] for k, v in p["layers"]["attn"].items()}
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, causal=True,
              attn_impl="flash")
    _close(L.multihead_attention(ta, torch.from_numpy(x), **kw),
           JL.multihead_attention(ja, jnp.asarray(x), **kw))


def test_chunked_prefill_matches_jax():
    """``attn_q_chunk`` below S: the einsum route's query blocks."""
    cfg, jcfg = _cfgs("granite-34b", attn_q_chunk=8)
    jp = JT.init(jax.random.PRNGKey(4), jcfg)
    p = T.params_from_jax(jp, cfg, "cpu")
    toks = _tokens(cfg, 2, 32, 3)
    _close(T.forward(p, torch.from_numpy(toks).long(), cfg)[0],
           JT.forward(jp, jnp.asarray(toks), jcfg)[0])


def test_decode_sequence_matches_jax_and_forward(model):
    cfg, jcfg, p, jp = model
    B, S_max, n = 2, 16, 10
    toks = _tokens(cfg, B, n, 2)
    cache = T.init_cache(cfg, B, S_max, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, B, S_max, cfg.n_kv_heads,
                                cfg.head_dim)
    jcache = JT.init_cache(jcfg, B, S_max)
    steps = []
    for t in range(n):
        tok = toks[:, t:t + 1]
        logits, cache = T.decode_step(p, cache, torch.from_numpy(tok).long(),
                                      t, cfg)
        jlogits, jcache = JT.decode_step(jp, jcache, jnp.asarray(tok), t,
                                         jcfg)
        _close(logits, jlogits)
        steps.append(logits[:, 0])
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    # decoding the prompt token by token reproduces the full forward
    full, _ = T.forward(p, torch.from_numpy(toks).long(), cfg)
    _close(torch.stack(steps, dim=1), full.numpy(), atol=1e-4)


def test_lm_config_is_frozen_and_has_head_dim():
    cfg = LMConfig("x", 2, 64, 4, 2, 128, 256)
    assert cfg.head_dim == 16
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.n_layers = 3


# ---------------------------------------------------------------------------
# bf16: the port's LM against JAX's bf16 LM
# ---------------------------------------------------------------------------

BF16_REL = 2e-2


@pytest.fixture(scope="module", params=["olmo-1b", "granite-34b"])
def bf16_model(request):
    cfg = reduced(get_arch(request.param), dtype="bfloat16")
    jcfg = jreduced(jget_arch(request.param), dtype="bfloat16")
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, T.params_from_jax(jp, cfg, "cpu"), jp


def _close_bf16(got, want):
    """The port's bf16 logits against JAX's bf16 logits: max |port − JAX|
    within 2e-2 of the largest |JAX logit|, and in every row the port's
    argmax is JAX's argmax up to that bound: JAX scores the port's choice
    within 2e-2 of the largest |JAX logit| below its own best. So the
    argmax is equal on every row whose top two JAX logits lie further
    apart than the bound.

    Why 2e-2: both LMs round to bf16 after every layer, but at other
    places. ``F.silu`` and ``F.gelu`` round once where XLA computes
    ``logistic`` and then ``mul`` in bf16, and 39-40% of those elements
    differ by an ulp. At this size JAX's own bf16 LM is up to 1.55% of the
    largest logit off its fp32 LM, and the port was measured at 0.86-1.20%
    off JAX's bf16 LM, so 2e-2 states bf16 rounding; a wrong weight, mask
    or position is 10-100% off. Why the argmax up to the bound: on reduced
    olmo-1b a few rows have top two logits 0.2-0.5% of the largest apart,
    inside that rounding, and there JAX's bf16 LM picks another token than
    its own fp32 LM as often as the port picks another than JAX's bf16 LM
    (2 and 3 rows of 96 over 6 token seeds of 8 decode steps). This bounds
    a comparison that had no check before; it loosens none."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    rel = np.abs(got - want).max() / scale
    assert rel <= BF16_REL, rel
    chosen = np.take_along_axis(want, got.argmax(-1)[..., None], -1)[..., 0]
    gap = (want.max(-1) - chosen) / scale
    assert gap.max() <= BF16_REL, gap.max()


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_bf16_prefill_matches_jax_bf16(bf16_model, attn_impl):
    """Both prefill routes (on the CPU the flash route takes the kernel's
    plain version) against the JAX package's bf16 prefill."""
    cfg, jcfg, p, jp = bf16_model
    toks = _tokens(cfg, 2, 32, 1)
    got = T.prefill(p, torch.from_numpy(toks).long(), cfg,
                    attn_impl=attn_impl)
    _close_bf16(got, JT.prefill(jp, jnp.asarray(toks), jcfg))


def test_bf16_forward_matches_jax_bf16(bf16_model):
    cfg, jcfg, p, jp = bf16_model
    toks = _tokens(cfg, 2, 32, 0)
    logits, _ = T.forward(p, torch.from_numpy(toks).long(), cfg)
    _close_bf16(logits, JT.forward(jp, jnp.asarray(toks), jcfg)[0])


def test_bf16_decode_matches_jax_bf16(bf16_model):
    """8 ``decode_step``s into a 16-slot cache, each step's logits held
    against JAX's."""
    cfg, jcfg, p, jp = bf16_model
    toks = _tokens(cfg, 2, 8, 2)
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    jcache = JT.init_cache(jcfg, 2, 16)
    for t in range(8):
        tok = toks[:, t:t + 1]
        logits, cache = T.decode_step(p, cache, torch.from_numpy(tok).long(),
                                      t, cfg)
        jlogits, jcache = JT.decode_step(jp, jcache, jnp.asarray(tok), t,
                                         jcfg)
        _close_bf16(logits, jlogits)
