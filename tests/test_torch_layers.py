"""The port's LM layers (``repro_torch.models.layers``) against the JAX
package's ``repro.models.layers`` on the same numpy inputs and the same
parameters (drawn by each package from one seed, which ``test_torch_prng``
holds equal, and checked equal here too). fp32 agrees to 1e-5 (sums in
another order); the one bf16 case to 3e-2 (bf16 rounds at other places in
the two frameworks; the JAX package's own bf16 attention tolerance). The
flash route runs the JAX package's Pallas kernel in interpret mode, as its
own tests do, and the port's plain version on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.common import prng
from repro_torch.models import layers as L

ATOL = 1e-5


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _t(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _t(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(dtype)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norms_match_jax(kind):
    x = _x((2, 5, 32), 0) * 3 + 1
    jp = JL.norm_init(kind, 32)
    jp = {k: v * 1.5 + 0.25 for k, v in jp.items()}
    p = _t(jp)
    assert set(p) == set(L.norm_init(kind, 32))
    _close(L.apply_norm(kind, p, torch.from_numpy(x)),
           JL.apply_norm(kind, jp, jnp.asarray(x)))


@pytest.mark.parametrize("dh,theta", [(16, 1e4), (64, 5e5)])
def test_rope_matches_jax(dh, theta):
    x = _x((2, 7, 3, dh), 1)
    pos = np.array([[3, 4, 5, 6, 7, 8, 9]] * 2, np.int32)
    _close(L.rope_freqs(dh, theta), JL.rope_freqs(dh, theta))
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_jax(act):
    jp = JL.mlp_init(jax.random.PRNGKey(2), 32, 64, act, jnp.float32)
    p = L.mlp_init(prng.key(2), 32, 64, act, torch.float32)
    assert set(p) == set(jp)
    for k in p:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
    x = _x((2, 5, 32), 3)
    _close(L.mlp(p, torch.from_numpy(x), act),
           JL.mlp(jp, jnp.asarray(x), act))


def _attn_params(H, KV, D=64, seed=4):
    jp = JL.attn_init(jax.random.PRNGKey(seed), D, H, KV, jnp.float32)
    p = L.attn_init(prng.key(seed), D, H, KV, torch.float32)
    for k in jp:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
    return p, jp


@pytest.mark.parametrize("H,KV,S,causal,window,q_chunk,impl", [
    (4, 4, 16, True, 0, 4096, "einsum"),
    (4, 2, 24, True, 0, 4096, "einsum"),      # GQA
    (4, 1, 24, True, 0, 8, "einsum"),         # MQA, q_chunk < S
    (4, 2, 24, True, 6, 8, "einsum"),         # sliding window, chunked
    (4, 4, 20, False, 0, 4096, "einsum"),     # full attention
    (4, 4, 32, True, 0, 4096, "flash"),
    (4, 2, 24, True, 0, 4096, "flash"),       # GQA through the kernel
    (4, 1, 50, True, 0, 4096, "flash"),       # ragged S, MQA
])
def test_multihead_attention_matches_jax(H, KV, S, causal, window, q_chunk,
                                         impl):
    p, jp = _attn_params(H, KV)
    x = _x((2, S, 64), 5)
    kw = dict(n_heads=H, n_kv_heads=KV, causal=causal, window=window,
              q_chunk=q_chunk, attn_impl=impl)
    got = L.multihead_attention(p, torch.from_numpy(x), **kw)
    want = JL.multihead_attention(jp, jnp.asarray(x), **kw)
    _close(got, want)
    if impl == "flash":     # and the flash route equals the einsum route
        _close(got, L.multihead_attention(p, torch.from_numpy(x),
                                          **dict(kw, attn_impl="einsum")))


def test_multihead_attention_bf16_matches_jax():
    p, jp = _attn_params(4, 2)
    pb = {k: v.to(torch.bfloat16) for k, v in p.items()}
    jpb = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    x = _x((2, 24, 64), 6)
    for impl in ("einsum", "flash"):
        got = L.multihead_attention(pb, torch.from_numpy(x).bfloat16(),
                                    n_heads=4, n_kv_heads=2, causal=True,
                                    attn_impl=impl)
        assert got.dtype == torch.bfloat16
        want = JL.multihead_attention(jpb, jnp.asarray(x, jnp.bfloat16),
                                      n_heads=4, n_kv_heads=2, causal=True,
                                      attn_impl=impl)
        _close(got, want, atol=3e-2)


def test_multihead_attention_rejects_unknown_impl():
    p, _ = _attn_params(4, 4)
    with pytest.raises(ValueError):
        L.multihead_attention(p, torch.zeros(1, 4, 64), n_heads=4,
                              n_kv_heads=4, causal=False, attn_impl="xla")


@pytest.mark.parametrize("H,KV,window", [(4, 4, 0), (4, 2, 0), (4, 1, 3)])
def test_decode_attention_matches_jax(H, KV, window):
    p, jp = _attn_params(H, KV)
    B, S_max, hd = 2, 12, 16
    ck = _x((B, S_max, KV, hd), 7)
    cv = _x((B, S_max, KV, hd), 8)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    jk, jv = jnp.asarray(ck), jnp.asarray(cv)
    for t, seed in ((0, 9), (5, 10), (11, 11)):
        x = _x((B, 1, 64), seed)
        kw = dict(n_heads=H, n_kv_heads=KV, window=window)
        out, tk, tv = L.decode_attention(p, torch.from_numpy(x), tk, tv, t,
                                         **kw)
        jout, jk, jv = JL.decode_attention(jp, jnp.asarray(x), jk, jv, t,
                                           **kw)
        _close(out, jout)
        _close(tk, jk)
        _close(tv, jv)


def test_dense_init_and_dtype_names():
    w = L.dense_init(prng.key(1), 8, 4, dtype=torch.bfloat16)
    jw = JL.dense_init(jax.random.PRNGKey(1), 8, 4, dtype=jnp.bfloat16)
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(jw, np.float32))
    assert L.compute_dtype("bfloat16") == torch.bfloat16
    assert L.compute_dtype("f32") == torch.float32
