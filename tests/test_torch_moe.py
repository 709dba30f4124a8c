"""The port's mixture-of-experts LM against the JAX package, on reduced
``moonshot-v1-16b-a3b`` (RMSNorm, 4 experts top-2 here, groups of 32) and
reduced ``dbrx-132b`` (LayerNorm, grouped KV), on the CPU.

- ``moe_init`` and ``init`` draw JAX's bits; the router ``gate`` stays
  fp32 in a bf16 config, through ``params_from_jax``/``params_to_jax``.
- ``layers.moe`` against JAX's ``moe`` on the same input, in both
  dispatch modes: ``y`` within 1e-5, ``aux`` within 1e-6 (fp32 sums in
  another order), and the routing (expert choice, slot ``within``,
  ``keep``) exactly equal to the JAX function's own lines
  (``_jax_route``), on inputs whose top-k margin is asserted to be at
  least 1e-4, so no near-tie can hide; a tie of equal probabilities goes
  to the lowest expert; cases with dropped tokens, a group size halved
  to divide T, and a decode step's C = 1.
- ``forward``, both prefill routes and a decode sequence within 1e-5 in
  fp32 and 2e-2 of the largest |logit| in bf16; ``loss_fn`` and its
  gradients (the aux term included) within 1e-5, and in bf16 each
  gradient leaf no farther from JAX's fp32 gradient than JAX's bf16 one
  plus 2e-2; remat on equals off, bit for bit; the training entry
  points' loss lines within 1e-3 in fp32, and in bf16 up to the first
  near-tie flip, and over all 10 steps once the port's router is handed
  JAX's choices.

A decode step routes its B tokens as one group, and ``forward`` routes
groups of up to ``moe_group_size``: the same position can get another
capacity cut, so MoE decode is held against JAX's ``decode_step`` and not
against ``forward``.
"""
import dataclasses
import functools
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.common.config import reduced as jreduced
from repro.configs import get_arch as jget_arch
from repro.launch import train as jlaunch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.common import prng
from repro_torch.common.config import reduced
from repro_torch.configs import get_arch
from repro_torch.launch import train as launch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.train_loop import param_leaves
from test_torch_hopper_cuda import _margin

ARCHS = ["moonshot-v1-16b-a3b", "dbrx-132b"]
ATOL = 1e-5


def _cfgs(arch, **kw):
    return reduced(get_arch(arch), **kw), jreduced(jget_arch(arch), **kw)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=atol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg, jcfg = _cfgs(request.param, dtype="float32")
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, T.params_from_jax(jp, cfg, "cpu"), jp


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def test_moe_init_equals_jax_moe_init():
    got = L.moe_init(prng.key(7), 64, 96, 8, torch.bfloat16)
    want = JL.moe_init(jax.random.PRNGKey(7), 64, 96, 8, jnp.bfloat16)
    assert got["gate"].dtype == torch.float32
    assert got["wi"].dtype == torch.bfloat16
    for k in ("gate", "wi", "wg", "wo"):
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 1])
def test_init_equals_jax_init(arch, seed):
    cfg, jcfg = _cfgs(arch, dtype="float32")
    got = T.params_to_jax(T.init(cfg, seed, "cpu"))
    want = JT.init(jax.random.PRNGKey(seed), jcfg)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    assert got["layers"]["moe"]["wi"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_gate_stays_fp32_and_round_trips(arch):
    cfg, jcfg = _cfgs(arch)                     # the config's bf16
    p = T.init(cfg, 0, "cpu")
    assert p["layers"]["moe"]["gate"].dtype == torch.float32
    assert p["layers"]["moe"]["wi"].dtype == torch.bfloat16
    want = JT.init(jax.random.PRNGKey(0), jcfg)
    assert want["layers"]["moe"]["gate"].dtype == jnp.float32
    for x, y in zip(jax.tree.leaves(T.params_to_jax(p)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, np.asarray(y, np.float32))
    back = T.params_from_jax(jax.tree.map(np.asarray, want), cfg, "cpu")
    assert back["layers"]["moe"]["gate"].dtype == torch.float32
    assert back["layers"]["moe"]["wo"].dtype == torch.bfloat16
    for x, y in zip(jax.tree.leaves(T.params_to_jax(back)),
                    jax.tree.leaves(T.params_to_jax(p))):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _jax_route(gate, x, top_k, group_size, cf):
    """The routing of JAX's ``layers.moe`` (``src/repro/models/layers.py``,
    the lines from the group split to ``keep``), which the function does
    not return: (probs, gate_idx, within, keep, C)."""
    probs, gate_idx, within, C = _jax_route_lines(gate, jnp.asarray(x),
                                                  top_k, group_size, cf)
    C = int(C)
    return (np.asarray(probs), np.asarray(gate_idx), np.asarray(within),
            np.asarray(within) < C, C)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_route_lines(gate, x, top_k, group_size, cf):
    B, S, D = x.shape
    E = gate.shape[1]
    T_ = B * S
    gs = min(group_size, T_)
    while T_ % gs:
        gs //= 2
    G = T_ // gs
    C = min(max(1, int(np.ceil(gs * top_k * cf / E))), gs)
    xg = x.reshape(G, gs, D)
    logits = jnp.einsum("gsd,de->gse", xg.astype(jnp.float32), gate)
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = lax.top_k(probs, top_k)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    oh = onehot.transpose(0, 2, 1, 3).reshape(G, top_k * gs, E)
    pos = jnp.cumsum(oh, axis=1) - oh
    pos = pos.reshape(G, top_k, gs, E).transpose(0, 2, 1, 3)
    within = (onehot * pos).sum(-1)
    return probs, gate_idx, within, C


# (B, S, experts, top-k, group size, capacity factor): the reduced
# configs' prefill; a factor that drops tokens; T = 40 in groups of 32,
# halved to 5 groups of 8; moonshot's decode step (E = 64, k = 6, 4
# tokens: C = 1)
MOE_CASES = {
    "prefill": (2, 32, 4, 2, 32, 1.25),
    "drops": (2, 32, 4, 2, 32, 0.5),
    "halved": (1, 40, 4, 2, 32, 1.25),
    "decode_c1": (4, 1, 64, 6, 1024, 1.25),
}


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_layer_matches_jax(case, dispatch):
    B, S, E, k, group, cf = MOE_CASES[case]
    D, F = 64, 96
    jp = JL.moe_init(jax.random.PRNGKey(11), D, F, E, jnp.float32)
    p = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    x = np.random.default_rng(5).normal(size=(B, S, D)).astype(np.float32)
    kw = dict(n_experts=E, top_k=k, group_size=group, capacity_factor=cf,
              dispatch=dispatch)
    y, aux = L.moe(p, torch.from_numpy(x), **kw)
    jy, jaux = jax.jit(functools.partial(JL.moe, **kw))(jp, jnp.asarray(x))
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)

    jprobs, jidx, jwithin, jkeep, C = _jax_route(jp["gate"], jnp.asarray(x),
                                                 k, group, cf)
    margin = _margin(torch.from_numpy(np.array(jprobs)), k)
    assert margin >= 1e-4, f"inputs hold a near-tie: margin {margin}"
    gs, G, C_port = L.moe_groups(B * S, group, k, cf, E)
    assert C_port == C and (G, gs) == jidx.shape[:2]
    _, idx, _, within, keep = L.moe_route(
        p["gate"], torch.from_numpy(x).reshape(G, gs, D), k, C)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(within.numpy(), jwithin)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    if case == "drops":
        assert not jkeep.all()
    if case == "halved":
        assert (G, gs) == (5, 8)
    if case == "decode_c1":
        assert C == 1 and not jkeep.all()


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_tie_goes_to_the_lowest_expert(dispatch):
    """A zero router gives every expert the same probability: each token
    takes experts 0..k-1, as ``lax.top_k`` does."""
    D, F, E, k = 32, 48, 8, 3
    jp = JL.moe_init(jax.random.PRNGKey(2), D, F, E, jnp.float32)
    jp = dict(jp, gate=jnp.zeros_like(jp["gate"]))
    p = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    x = np.random.default_rng(6).normal(size=(2, 8, D)).astype(np.float32)
    _, idx, gate_vals, _, _ = L.moe_route(
        p["gate"], torch.from_numpy(x).reshape(1, 16, D), k, 16)
    assert (idx.numpy() == np.arange(k)).all()
    np.testing.assert_allclose(gate_vals.numpy(), 1 / k, rtol=1e-6)
    _, jidx, _, _, _ = _jax_route(jp["gate"], jnp.asarray(x), k, 16, 1.25)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    kw = dict(n_experts=E, top_k=k, group_size=16, capacity_factor=1.25,
              dispatch=dispatch)
    y, aux = L.moe(p, torch.from_numpy(x), **kw)
    jy, jaux = jax.jit(functools.partial(JL.moe, **kw))(jp, jnp.asarray(x))
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


def test_moe_dispatch_modes_agree_and_unknown_raises():
    cfg, _ = _cfgs("moonshot-v1-16b-a3b", dtype="float32")
    p = T.init(cfg, 3, "cpu")
    lp = {k: v[0] for k, v in p["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
              group_size=cfg.moe_group_size,
              capacity_factor=cfg.moe_capacity_factor)
    a, aux_a = L.moe(lp, x, dispatch="einsum", **kw)
    b, aux_b = L.moe(lp, x, dispatch="scatter", **kw)
    _close(a, b.numpy())
    assert float(aux_a) == float(aux_b)
    with pytest.raises(ValueError, match="dispatch"):
        L.moe(lp, x, dispatch="dense", **kw)


# ---------------------------------------------------------------------------
# the whole LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_forward_matches_jax(model, dispatch):
    cfg, jcfg, p, jp = model
    cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    jcfg = dataclasses.replace(jcfg, moe_dispatch=dispatch)
    toks = _tokens(cfg, 2, 24, 0)
    logits, aux = T.forward(p, torch.from_numpy(toks).long(), cfg)
    jlogits, jaux = JT.forward(jp, jnp.asarray(toks), jcfg)
    assert logits.shape == (2, 24, cfg.vocab_size)
    _close(logits, jlogits)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_prefill_matches_jax(model, attn_impl):
    cfg, jcfg, p, jp = model
    toks = _tokens(cfg, 2, 37, 1)
    got = T.prefill(p, torch.from_numpy(toks).long(), cfg,
                    attn_impl=attn_impl)
    assert got.shape == (2, 1, cfg.vocab_size)
    _close(got, JT.prefill(jp, jnp.asarray(toks), jcfg))


def test_decode_sequence_matches_jax(model):
    cfg, jcfg, p, jp = model
    B, S_max, n = 2, 16, 10
    toks = _tokens(cfg, B, n, 2)
    cache = T.init_cache(cfg, B, S_max, device="cpu")
    jcache = JT.init_cache(jcfg, B, S_max)
    jdecode = jax.jit(functools.partial(JT.decode_step, cfg=jcfg))
    for t in range(n):
        tok = toks[:, t:t + 1]
        logits, cache = T.decode_step(p, cache, torch.from_numpy(tok).long(),
                                      t, cfg)
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(tok),
                                  jnp.int32(t))
        _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


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


def _batch(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return toks, np.roll(toks, -1, axis=1)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_loss_fn_and_grads_match_jax(model, dispatch):
    cfg, jcfg, p, jp = model
    cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    jcfg = dataclasses.replace(jcfg, moe_dispatch=dispatch)
    toks, labels = _batch(cfg, 2, 16, 1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda q, t, y: JT.loss_fn(q, t, y, jcfg), has_aux=True))(
        jp, toks.astype(np.int32), labels.astype(np.int32))
    loss, metrics, grads = _grads(cfg, p, toks, labels)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["nll"]), float(jm["nll"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                               rtol=0, atol=1e-6)
    assert float(metrics["aux"]) > 0
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for g, jgl in zip(grads, jleaves):
        jgl = np.asarray(jgl)
        assert g.shape == jgl.shape
        np.testing.assert_allclose(g.numpy(), jgl, rtol=0,
                                   atol=1e-5 * np.abs(jgl).max())
    assert p["layers"]["moe"]["gate"].shape == (cfg.n_layers, cfg.d_model,
                                                 cfg.n_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_off_bitwise(arch):
    cfg, _ = _cfgs(arch)                        # the config's bf16
    params = T.init(cfg, 0, "cpu")
    toks, labels = _batch(cfg, 2, 24, 3)
    on = dataclasses.replace(cfg, remat=True)
    l0, m0, g0 = _grads(cfg, params, toks, labels)
    l1, m1, g1 = _grads(on, params, toks, labels)
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------------------
# bf16 against JAX's bf16 LM, and the training entry points
# ---------------------------------------------------------------------------

BF16_REL = 2e-2


@pytest.fixture(scope="module", params=ARCHS)
def bf16_model(request):
    cfg, jcfg = _cfgs(request.param, dtype="bfloat16")
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    # unrolled, so that JAX's LM calls its MoE layers in layer order
    jcfg = dataclasses.replace(jcfg, scan_layers=False)
    jit = {name: jax.jit(functools.partial(getattr(JT, name), cfg=jcfg))
           for name in ("forward", "prefill", "decode_step")}
    for mode in ("einsum", "scatter"):
        for name, dt in (("loss_", "bfloat16"), ("loss32_", "float32")):
            jit[name + mode] = jax.jit(jax.value_and_grad(
                functools.partial(_jax_loss, cfg=dataclasses.replace(
                    jcfg, moe_dispatch=mode, dtype=dt)), has_aux=True))
    return cfg, jit, T.params_from_jax(jp, cfg, "cpu"), jp


def _jax_loss(params, tokens, labels, cfg):
    return JT.loss_fn(params, tokens, labels, cfg)


# JAX's routing, appended as its compiled LM runs: the callbacks that
# append are traced into the module's compiled functions once, so the
# list outlives a test
_JAX_ROUTES = []


@pytest.fixture
def routes(monkeypatch):
    """Every MoE call's routing in both LMs, in call order: the port's
    ``moe_route`` (probs, idx, gate values, within, keep) and, for JAX's
    ``moe``, the routing lines of the same function on the same input
    (probs, idx, within, keep), read back as JAX's compiled LM runs."""
    got = []
    _JAX_ROUTES.clear()
    port_route, jax_moe = L.moe_route, JL.moe

    def record_port(*a):
        out = port_route(*a)
        got.append([t.detach().numpy() for t in out])
        return out

    def record_jax(params, x, *, top_k, group_size, capacity_factor, **kw):
        probs, idx, within, C = _jax_route_lines(
            params["gate"], x, top_k, group_size, capacity_factor)
        jax.debug.callback(
            lambda *a: _JAX_ROUTES.append([np.asarray(v) for v in a]),
            probs, idx, within, within < C, ordered=True)
        return jax_moe(params, x, top_k=top_k, group_size=group_size,
                       capacity_factor=capacity_factor, **kw)

    monkeypatch.setattr(L, "moe_route", record_port)
    monkeypatch.setattr(JL, "moe", record_jax)
    return got, _JAX_ROUTES


def _close_bf16(got, want, routes):
    """The port's bf16 logits within 2e-2 of the largest |JAX logit|: the
    dense LM's bf16 bound (``tests/test_torch_transformer.py::
    _close_bf16`` says why), on inputs that both LMs route alike in every
    layer, which is asserted first. A token whose top k + 1 router
    probabilities lie within bf16 rounding of each other can take other
    experts, or another order and so other slots, in the two LMs; that is
    another function, not a rounding (ROADMAP C14, and
    ``test_bf16_routing_flips_only_at_near_ties``)."""
    want = np.asarray(want, np.float32)
    _assert_same_routes(routes)
    got = got.float().numpy()
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= BF16_REL, rel


def _assert_same_routes(routes):
    """Both LMs made the same MoE calls and every one chose the same
    experts and kept the same choices; the records are then cleared."""
    jax.effects_barrier()
    got_r, want_r = routes
    assert len(got_r) == len(want_r) > 0
    for a, b in zip(got_r, want_r):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[4], b[3])
    got_r.clear()
    want_r.clear()


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_bf16_prefill_matches_jax_bf16(bf16_model, routes, attn_impl):
    cfg, jit, p, jp = bf16_model
    toks = _tokens(cfg, 1, 8, 1)
    got = T.prefill(p, torch.from_numpy(toks).long(), cfg,
                    attn_impl=attn_impl)
    _close_bf16(got, jit["prefill"](jp, jnp.asarray(toks)), routes)


def test_bf16_forward_and_decode_match_jax_bf16(bf16_model, routes):
    cfg, jit, p, jp = bf16_model
    toks = _tokens(cfg, 1, 8, 3)
    logits, _ = T.forward(p, torch.from_numpy(toks).long(), cfg)
    _close_bf16(logits, jit["forward"](jp, jnp.asarray(toks))[0], routes)
    cache = T.init_cache(cfg, 1, 8, device="cpu")
    jcache = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
              for k, v in cache.items()}
    for t in range(8):
        tok = toks[:, t:t + 1]
        logits, cache = T.decode_step(p, cache, torch.from_numpy(tok).long(),
                                      t, cfg)
        jlogits, jcache = jit["decode_step"](jp, jcache, jnp.asarray(tok),
                                             jnp.int32(t))
        _close_bf16(logits, jlogits, routes)


def test_bf16_routing_flips_only_at_near_ties(bf16_model, routes):
    """bf16 forwards of 2 x 32 tokens, where routing does differ between
    the LMs: in the first layer that routes a token otherwise, each such
    token's first differing choice is a near-tie, the gap JAX sees between
    the two experts at most twice the largest difference between the two
    LMs' probabilities for the token. (Later layers see inputs that the
    flip changed, and a flip moves other tokens' slots.)"""
    cfg, jit, p, jp = bf16_model
    got_r, want_r = routes
    flips = 0
    for seed in range(4):
        toks = _tokens(cfg, 2, 32, seed)
        T.forward(p, torch.from_numpy(toks).long(), cfg)
        jax.block_until_ready(jit["forward"](jp, jnp.asarray(toks)))
        jax.effects_barrier()
        assert len(got_r) == len(want_r) == cfg.n_layers
        flips += len(_first_flips(got_r, want_r)[1])
        got_r.clear()
        want_r.clear()
    assert flips > 0        # these inputs do hold near-ties


def _first_flips(got_r, want_r):
    """The first MoE call whose choices differ between the two LMs' route
    records, and its flips: for each token that chose otherwise, its
    first differing choice is asserted to be a near-tie, the gap JAX
    sees between the two experts at most twice the largest difference
    between the LMs' probabilities for the token. (None, []) when every
    call chose alike."""
    for n, (a, b) in enumerate(zip(got_r, want_r)):
        differ = (a[1] != b[1]).any(-1)
        if not differ.any():
            continue
        flips = []
        for g, s in zip(*np.nonzero(differ)):
            j = int(np.argmax(a[1][g, s] != b[1][g, s]))
            e_port, e_jax = a[1][g, s, j], b[1][g, s, j]
            gap = float(b[0][g, s, e_jax] - b[0][g, s, e_port])
            noise = float(np.abs(a[0][g, s] - b[0][g, s]).max())
            assert 0 <= gap <= 2 * noise, (n, g, s, gap, noise)
            flips.append((gap, noise))
        return n, flips
    return None, []


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_bf16_loss_fn_and_grads_match_jax_bf16(bf16_model, routes,
                                               dispatch):
    """bf16 ``loss_fn`` and its gradients against ``jax.value_and_grad``
    of JAX's bf16 LM, the backward pass through the router's gather, the
    combine weights and the dispatch, on a batch of 2 x 16 tokens that
    the port's bf16 LM, JAX's bf16 LM and JAX's fp32 LM on the same
    weights widened all route alike in every layer (asserted): the loss
    within the dense LM's bf16 1e-3 of JAX's, aux within 1e-3 relative,
    and each gradient leaf held against JAX's fp32 gradient g32: the
    port's relative L2 error ||g - g32|| / ||g32|| at most JAX's own bf16
    error plus the dense LM's bf16 2e-2. Two bf16 gradients differ by
    the roundings of both: measured on the CPU (reduced olmo-1b,
    granite-34b, moonshot and dbrx, inputs that route alike), each LM's
    farthest leaf lies 1.2e-2 to 3.2e-2 (L2) from g32, and no leaf of
    the port's lies more than 4.1e-3 farther than JAX's (2.4e-3 for the
    MoE LMs). The two bf16 gradients differ by up to 1.8e-2 for the
    dense LMs and 2.9e-2 for the MoE LMs, in a case where JAX's lay
    3.2e-2 from g32 and the port's 2.0e-2: a bound on that difference
    weighs JAX's rounding as much as the port's, while a defect in one
    path's backward moves its error by far more."""
    cfg, jit, p, jp = bf16_model
    cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    toks, labels = _batch(cfg, 2, 16, 2)
    loss, metrics, grads = _grads(cfg, p, toks, labels)
    t, y = toks.astype(np.int32), labels.astype(np.int32)
    (jl, jm), jg = jit["loss_" + dispatch](jp, t, y)
    jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    _, jg32 = jit["loss32_" + dispatch](jp32, t, y)
    jax.effects_barrier()
    got_r, want_r = routes
    n = cfg.n_layers
    assert len(got_r) == n and len(want_r) == 2 * n
    _assert_same_routes((got_r * 2, want_r))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                               rtol=1e-3)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for g, jgl, g32 in zip(grads, jleaves, jax.tree.leaves(jg32)):
        assert g.shape == jgl.shape and g.dtype == (
            torch.float32 if jgl.dtype == jnp.float32 else torch.bfloat16)
        g32 = np.asarray(g32)
        scale = np.linalg.norm(g32)
        err = np.linalg.norm(g.float().numpy() - g32) / scale
        jerr = np.linalg.norm(np.asarray(jgl, np.float32) - g32) / scale
        assert err <= jerr + BF16_REL, (err, jerr)


def _loss_lines(text):
    return [(int(s), float(l)) for s, l in
            re.findall(r"step\s+(\d+) loss (\S+) \(", text)]


def test_launch_train_matches_jax_entry_point(capsys, monkeypatch):
    """Both entry points on reduced moonshot, 10 steps, their configs in
    fp32 (neither command line has a dtype flag): loss lines within the
    dense LM's 1e-3. In the config's bf16 the two LMs route some tokens
    otherwise at near-ties and their loss lines part
    (``test_launch_train_bf16_parts_from_jax_only_at_near_tie_flips``)."""
    for mod, get in ((jlaunch, jget_arch), (launch, get_arch)):
        monkeypatch.setattr(mod, "get_arch", lambda a, get=get:
                            dataclasses.replace(get(a), dtype="float32"))
    argv = ["--arch", "moonshot-v1-16b-a3b", "--steps", "10"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    assert jlaunch.main() == 0
    want = capsys.readouterr().out
    report = launch.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]   # arch, params
    g, w = _loss_lines(got), _loss_lines(want)
    assert [s for s, _ in g] == [s for s, _ in w] == list(range(1, 11))
    np.testing.assert_allclose([x for _, x in g], [x for _, x in w],
                               rtol=1e-3)
    assert report["arch"] == "moonshot-v1-16b-a3b-smoke"


def test_launch_train_bf16_parts_from_jax_only_at_near_tie_flips(
        capsys, monkeypatch, routes):
    """Both entry points on reduced moonshot in the config's bf16, 10
    steps, with every MoE call's routing recorded (JAX's layers unrolled,
    so that its calls come in layer order; nothing else changed). The
    first call that routes a token otherwise flips only near-ties
    (``_first_flips``), and the loss lines agree within the dense LM's
    1e-3 up to that step. Then the port runs again with its router's
    top-k handed JAX's choices, call for call, the rest of its routing
    its own: its slots and capacity cut equal JAX's in every call, and
    all 10 loss lines lie within 1e-3 of JAX's. So the near-tie flips
    are what parts the bf16 lines (ROADMAP C14)."""
    got_r, want_r = routes
    monkeypatch.setattr(jlaunch, "get_arch", lambda a: dataclasses.replace(
        jget_arch(a), scan_layers=False))
    argv = ["--arch", "moonshot-v1-16b-a3b", "--steps", "10"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    assert jlaunch.main() == 0
    jax.effects_barrier()
    w = _loss_lines(capsys.readouterr().out)
    jax_routes = list(want_r)
    n = len(jax_routes) // 10                   # MoE calls a step
    assert n == 2 and len(jax_routes) == 10 * n

    launch.main(argv + ["--device", "cpu"])
    g = _loss_lines(capsys.readouterr().out)
    assert [s for s, _ in g] == [s for s, _ in w] == list(range(1, 11))
    first, flips = _first_flips(got_r, jax_routes)
    assert first is not None and flips
    step = first // n + 1
    np.testing.assert_allclose([x for _, x in g[:step - 1]],
                               [x for _, x in w[:step - 1]], rtol=1e-3)

    got_r.clear()
    choices = iter(r[1] for r in jax_routes)

    def jax_choices(x, k):
        idx = torch.from_numpy(np.array(next(choices))).reshape(-1, k)
        return x.gather(1, idx.long()), idx

    monkeypatch.setattr(L.ops, "topk", jax_choices)
    launch.main(argv + ["--device", "cpu"])
    forced = _loss_lines(capsys.readouterr().out)
    assert len(got_r) == len(jax_routes)
    for a, b in zip(got_r, jax_routes):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[3], b[2])      # within
        np.testing.assert_array_equal(a[4], b[3])      # keep
    np.testing.assert_allclose([x for _, x in forced], [x for _, x in w],
                               rtol=1e-3)
