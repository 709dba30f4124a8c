"""The port's diffusion transformer (``repro_torch.models.dit``) and the
draws it makes (``prng.randint``) against the JAX package, on reduced
dit-b2 and the same seeded numpy inputs, on the CPU.

- ``prng.randint``: bitwise ``jax.random.randint`` for several shapes and
  spans (one value, a power of two, 1000, the whole int32 range, an
  empty span).
- The DDIM timesteps: exactly ``jnp.linspace(999, 0, n).astype(int32)``
  for n in {1, 2, 4, 10, 50, 1000} and around the length where XLA's CPU
  loop starts fusing (``dit._linspace``).
- ``alpha_bars``: within 1e-6 relative (XLA's ``cumprod`` groups its
  products otherwise; ROADMAP C16).
- ``init``: every leaf bitwise JAX's, fp32 and bf16. adaLN-Zero makes
  the adaLN and final leaves zeros, and so the model's output; every test
  below first replaces each zero leaf by seeded normals (scale 0.05) in
  both packages (through ``params_from_jax``), so that the outputs
  compare non-zero numbers.
- fp32 ``forward`` (noise and sigma) at the config's latent grid, a
  larger one and a smaller one (pos table resized), ``loss_fn`` (the
  timesteps and the noise drawn bitwise from the same key) with its
  gradients, and ``sample`` (2 and 4 steps): within 1e-5 of the largest
  |out| (gradients of each leaf's largest |grad|). bf16 forward within
  2e-2, as the LM (ROADMAP C9).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import DIT_SHAPES as J_DIT_SHAPES
from repro.common.config import reduced as jreduced
from repro.configs import get_arch as jget_arch
from repro.configs import get_shapes as jget_shapes
from repro.models import dit as JD
from repro_torch.common import prng
from repro_torch.common.config import DIT_SHAPES, reduced
from repro_torch.configs import get_arch, get_shapes
from repro_torch.models import dit as D
from repro_torch.models import layers as L
from repro_torch.train.checkpoint import flatten


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---------------------------------------------------------------------------
# randint, the timesteps and the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shape,lo,hi", [
    (0, (16,), 0, 1000), (1, (3, 5), -7, 9), (2, (1000,), 0, 2 ** 31 - 1),
    (3, (64,), -2 ** 31, 2 ** 31 - 1), (4, (33,), 5, 5), (5, (40,), 9, 3),
    (6, (2, 2, 2), -100, 2 ** 20), (7, (0,), 0, 5), (8, (4096,), 0, 256)])
def test_randint_is_jax_bitwise(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                         lo, hi))
    got = prng.randint(prng.key(seed), shape, lo, hi)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        prng.randint(prng.key(seed), shape, 0, 2 ** 31)


@pytest.mark.parametrize("n", [1, 2, 4, 10, 50, 351, 352, 353, 354, 385,
                               999, 1000, 1001])
def test_ddim_timesteps_are_jax_exact(n):
    want = np.asarray(jnp.linspace(JD.N_TRAIN_STEPS - 1, 0, n)
                      .astype(jnp.int32))
    assert D.ddim_timesteps(n) == want.tolist()
    np.testing.assert_array_equal(
        D._linspace(JD.N_TRAIN_STEPS - 1, 0, n),
        np.asarray(jnp.linspace(JD.N_TRAIN_STEPS - 1, 0, n)))


def test_gen_fast_timesteps_truncate():
    assert D.ddim_timesteps(4) == [999, 665, 332, 0]
    assert torch.linspace(999, 0, 4).int().tolist() == [999, 666, 333, 0]


def test_alpha_bars_within_1e6():
    want = np.asarray(JD.alpha_bars())
    got = D.alpha_bars().numpy()
    assert got.dtype == np.float32 and got.shape == (1000,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert D.alpha_bars() is D.alpha_bars()               # cached


def test_timestep_embedding_matches_jax():
    """XLA's ``exp`` and torch's part by an ulp on a few of the 128
    frequencies; times t <= 999 that moves an angle by up to ~6e-5, so
    cos and sin agree within 1e-4 (measured 2.8e-5)."""
    t = np.array([0, 1, 17, 500, 999], np.int32)
    want = np.asarray(JD.timestep_embedding(jnp.asarray(t)))
    got = D.timestep_embedding(torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (5, 256)
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# configs, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n", [("dit-b2", 128999424),
                                    ("dit-s2", 32501760)])
def test_dit_configs_equal_jax(arch, n):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params() == n
    assert (cfg.d_ff, cfg.head_dim, cfg.n_tokens(), cfg.n_tokens(512)) == \
        (jcfg.d_ff, jcfg.head_dim, 256, 1024)
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(
        jreduced(jcfg))
    assert {k: dataclasses.asdict(v) for k, v in DIT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_DIT_SHAPES.items()}
    assert get_shapes(arch).keys() == jget_shapes(arch).keys()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dit_init_is_jax_bitwise(dtype):
    cfg = reduced(get_arch("dit-b2"), dtype=dtype)
    jcfg = jreduced(jget_arch("dit-b2"), dtype=dtype)
    jp = JD.init(jax.random.PRNGKey(0), jcfg)
    p = D.init(cfg, 0, "cpu")
    got, want = flatten(p)[0], jax.tree.leaves(jp)
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert str(g.dtype) == "torch." + str(w.dtype)
        assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32))
    zeros = [k for k, v in jax.tree_util.tree_leaves_with_path(jp)
             if not np.asarray(v, np.float32).any()]
    assert len(zeros) == 9         # adaLN-Zero, the final layer, the biases


@pytest.fixture(scope="module")
def model():
    """Reduced dit-b2 in fp32: JAX's init with every zero leaf replaced by
    seeded normals, as numpy, the JAX tree and the port's tree."""
    jcfg = jreduced(jget_arch("dit-b2"), dtype="float32")
    cfg = reduced(get_arch("dit-b2"), dtype="float32")
    r = np.random.default_rng(5)

    def perturb(a):
        a = np.asarray(a, np.float32)
        return a if a.any() else (r.normal(size=a.shape)
                                  * 0.05).astype(np.float32)

    tree = jax.tree.map(perturb, JD.init(jax.random.PRNGKey(0), jcfg))
    return (cfg, jcfg, tree, jax.tree.map(jnp.asarray, tree),
            D.params_from_jax(tree, cfg, "cpu"))


def _latents(B, g, seed):
    return np.random.default_rng(seed).normal(size=(B, g, g, 4)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# forward, loss, gradients, sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [4, 8, 2])
def test_dit_forward_fp32_matches_jax(model, g):
    cfg, jcfg, _, jp, p = model
    lat = _latents(3, g, g)
    t = np.array([0, 421, 999], np.int32)
    y = np.array([0, 7, 16], np.int32)              # 16: the null class
    jn, js = jax.jit(lambda q, a, b, c: JD.forward(q, a, b, c, jcfg))(
        jp, lat, t, y)
    with torch.no_grad():
        n, s = D.forward(p, torch.from_numpy(lat), torch.from_numpy(t),
                         torch.from_numpy(y), cfg)
    assert n.shape == s.shape == (3, g, g, 4)
    assert n.dtype == s.dtype == torch.float32
    assert _rel(n, jn) <= 1e-5 and _rel(s, js) <= 1e-5


def test_dit_forward_bf16_within_2e2(model):
    _, _, tree, _, _ = model
    jcfg = jreduced(jget_arch("dit-b2"))
    cfg = reduced(get_arch("dit-b2"))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    p = D.params_from_jax(tree, cfg, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in flatten(p)[0])
    lat, t, y = _latents(4, 4, 3), np.array([3, 50, 600, 998]), \
        np.array([1, 2, 3, 4])
    jn, js = jax.jit(lambda q, a, b, c: JD.forward(q, a, b, c, jcfg))(
        jp, lat, t, y)
    with torch.no_grad():
        n, s = D.forward(p, torch.from_numpy(lat), torch.from_numpy(t),
                         torch.from_numpy(y), cfg)
    assert _rel(n, jn) <= 2e-2 and _rel(s, js) <= 2e-2


def test_dit_loss_draws_and_grads_match_jax(model):
    cfg, jcfg, tree, jp, p = model
    lat, y = _latents(4, 4, 9), np.array([1, 5, 9, 16], np.int32)
    key = 11
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda q: JD.loss_fn(q, lat, y, jax.random.PRNGKey(key), jcfg),
        has_aux=True))(jp)
    # the loss's draws: JAX's split, randint and normal, bit for bit
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    t1, t2 = prng.split(prng.key(key))
    np.testing.assert_array_equal(
        prng.randint(t1, (4,), 0, 1000).numpy(),
        np.asarray(jax.random.randint(k1, (4,), 0, 1000)))
    np.testing.assert_array_equal(
        prng.normal(t2, lat.shape).numpy(),
        np.asarray(jax.random.normal(k2, lat.shape, jnp.float32)))
    leaves = flatten(p)[0]
    for t in leaves:
        t.requires_grad_(True)
    loss, m = D.loss_fn(p, torch.from_numpy(lat), torch.from_numpy(y),
                        prng.key(key), cfg)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert set(m) == {"mse"} and not m["mse"].requires_grad
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(grads) == len(jleaves)
    for g, (path, j) in zip(grads, jleaves):
        j = np.asarray(j)
        # t_embed/w1's gradient is the timestep embedding times the
        # upstream gradient: it carries the embedding's ulp of exp
        # (test_timestep_embedding_matches_jax; measured 1.3e-5-1.8e-5)
        tol = 5e-5 if jax.tree_util.keystr(path) == "['t_embed']['w1']" \
            else 1e-5
        np.testing.assert_allclose(g.numpy(), j, rtol=0,
                                   atol=tol * np.abs(j).max())


@pytest.mark.parametrize("n_steps", [2, 4])
def test_dit_sample_matches_jax(model, n_steps):
    cfg, jcfg, _, jp, p = model
    y = np.array([0, 3, 16], np.int32)
    want = np.asarray(JD.sample(jp, jax.random.PRNGKey(3), jnp.asarray(y),
                                jcfg, cfg.img_res, n_steps))
    got = D.sample(p, prng.key(3), torch.from_numpy(y), cfg, cfg.img_res,
                   n_steps)
    assert got.shape == (3, 4, 4, 4) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5
    assert not torch.is_grad_enabled() or not got.requires_grad


def test_params_round_trip(model):
    cfg, _, tree, _, p = model
    back = D.params_to_jax(p)
    for a, b in zip(flatten(back)[0], jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert L.tree_to_jax(p).keys() == tree.keys()
