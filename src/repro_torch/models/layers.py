"""The neural-net layers the dense decoder LM runs: norms, rotary
embeddings, GQA attention (prefill with causal/window masks, and one-token
decode against a KV cache) and the dense MLP.

A port of the parts of ``repro.models.layers`` that ``models.transformer``
reaches, with the JAX package's layouts at every public function:
parameters are dictionaries of tensors shaped as the JAX tree (dense
weights (d_in, d_out), applied as ``x @ w``), activations (B, S, D), heads
(B, S, H, dh). ``*_init`` draws through ``common.prng`` exactly as the JAX
package draws through ``jax.random``. Left out: the mesh constraints (one
card), the remat policies that save matrix products (``remat_policy``
raises on them), MoE and the vision primitives.

Matrix products stay ``torch.matmul``/``einsum``, as the JAX package
leaves them to XLA; the one kernel of this module's path is
``hopper.ops.flash_attention`` on ``attn_impl="flash"``. Where the JAX
package asks a product for fp32 results from low-precision inputs
(``preferred_element_type=float32``), the port widens the inputs to fp32
first: a product of two bf16 values is exact in fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common import prng
from repro_torch.hopper import ops

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "bf16": torch.bfloat16, "f32": torch.float32}


def remat_policy(name: str):
    """The activation-checkpoint policy of ``cfg.remat_policy``, as the
    JAX package names them. ``"nothing"`` (every LM config's) saves only
    each layer's input and recomputes the rest: ``None``, i.e. a plain
    ``torch.utils.checkpoint.checkpoint`` around the layer. The policies
    that also save matrix products (``"dots"``, ``"dots_nobatch"``) are
    not ported yet (ROADMAP A14)."""
    if name == "nothing":
        return None
    if name in ("dots", "dots_nobatch"):
        raise NotImplementedError(
            f"remat_policy {name!r} is not ported yet (ROADMAP A14); "
            f"use 'nothing'")
    raise ValueError(name)


def compute_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``dtype``'s ``"bfloat16"``/``"float32"``, or
    ``attn_scores_dtype``'s ``"bf16"``/``"f32"``) as a torch dtype."""
    return _DTYPES[name]


def dense_init(key: torch.Tensor, d_in: int, d_out: int,
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``normal(key, (d_in, d_out)) * scale`` in fp32 (scale 1/sqrt(d_in)
    by default), then cast: the JAX package's ``dense_init``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (prng.normal(key, (d_in, d_out)) * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * params["scale"]).to(dt)


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5):
    """LayerNorm in fp32; without parameters (``{}``) it is OLMo's
    non-parametric LN."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if params:
        x = x * params["scale"] + params["bias"]
    return x.to(dt)


def norm_init(kind: str, d: int, device=None) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    if kind == "nonparametric_ln":     # OLMo: LN without affine params
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, params: dict, x: torch.Tensor):
    if kind == "rmsnorm":
        return rmsnorm(params, x)
    return layernorm(params, x)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (dh/2,)
    angles = positions[..., None].float() * freqs           # (..., S, dh/2)
    angles = angles[..., None, :]                           # (..., S, 1, dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, full / sliding-window / decode with KV cache)
# ---------------------------------------------------------------------------

def attn_init(key: torch.Tensor, d_model: int, n_heads: int,
              n_kv_heads: int, dtype: torch.dtype) -> dict:
    hd = d_model // n_heads
    ks = prng.split(key, 4)
    return {
        "wq": dense_init(ks[0], d_model, n_heads * hd, dtype=dtype),
        "wk": dense_init(ks[1], d_model, n_kv_heads * hd, dtype=dtype),
        "wv": dense_init(ks[2], d_model, n_kv_heads * hd, dtype=dtype),
        "wo": dense_init(ks[3], n_heads * hd, d_model, dtype=dtype),
    }


def multihead_attention(params: dict, x: torch.Tensor, *, n_heads: int,
                        n_kv_heads: int, causal: bool, window: int = 0,
                        positions: Optional[torch.Tensor] = None,
                        theta: float = 10000.0, use_rope: bool = True,
                        attn_impl: str = "einsum", q_chunk: int = 4096,
                        scores_dtype: torch.dtype = torch.float32):
    """Self attention over x: (B, S, D). Returns (B, S, D).

    ``attn_impl="flash"`` (causal, no window) runs the ``flash_attention``
    kernel on K/V repeated to every head; otherwise the einsum route:
    fp32 (or ``scores_dtype``) scores, causal keys past a query block
    sliced off rather than masked, and query blocks of ``q_chunk`` rows
    when S is a larger multiple of it."""
    B, S, D = x.shape
    hd = D // n_heads
    g = n_heads // n_kv_heads
    q = (x @ params["wq"]).reshape(B, S, n_kv_heads * g, hd)
    k = (x @ params["wk"]).reshape(B, S, n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, n_kv_heads, hd)
    if use_rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    kf = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
    vf = torch.repeat_interleave(v, g, dim=2) if g > 1 else v

    if attn_impl == "flash" and causal and window == 0:
        out = ops.flash_attention(q, kf, vf, causal=True)
        return out.reshape(B, S, n_heads * hd) @ params["wo"]
    if attn_impl not in ("einsum", "flash"):
        raise ValueError(f"attn_impl must be 'einsum' or 'flash', got "
                         f"{attn_impl!r}")

    neg = -1e30 if scores_dtype == torch.float32 else -3e38

    def attend(q_blk, q0, Sq, k_end=None):
        """softmax(q_blk . k^T[:k_end]) . v[:k_end] for a query block at
        q0; causal callers pass k_end = q0 + Sq, so later keys are sliced
        off and only the (Sq, Sq) diagonal block is masked."""
        kk = kf if k_end is None else kf[:, :k_end]
        vv = vf if k_end is None else vf[:, :k_end]
        Sk = kk.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(),
                         kk.float()).to(scores_dtype) / math.sqrt(hd)
        if causal or window:
            if causal and Sk == q0 + Sq and not window:
                diag = torch.ones((Sq, Sq), dtype=torch.bool,
                                  device=x.device).tril()
                s = torch.cat([s[..., :q0],
                               s[..., q0:].masked_fill(~diag, neg)], dim=-1)
            else:
                qpos = q0 + torch.arange(Sq, device=x.device)[:, None]
                kpos = torch.arange(Sk, device=x.device)[None, :]
                mask = torch.ones((Sq, Sk), dtype=torch.bool,
                                  device=x.device)
                if causal:
                    mask &= kpos <= qpos
                if window:
                    mask &= kpos > qpos - window
                s = s.masked_fill(~mask, neg)
        w = torch.softmax(s, dim=-1).to(x.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, vv.to(w.dtype))

    if q_chunk and S > q_chunk and S % q_chunk == 0:
        outs = []
        for q0 in range(0, S, q_chunk):
            k_end = q0 + q_chunk if (causal and not window) else None
            outs.append(attend(q[:, q0:q0 + q_chunk], q0, q_chunk,
                               k_end=k_end))
        out = torch.cat(outs, dim=1)
    else:
        out = attend(q, 0, S)
    return out.reshape(B, S, n_heads * hd) @ params["wo"]


def decode_attention(params: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len: int, *, n_heads: int,
                     n_kv_heads: int, theta: float = 10000.0,
                     use_rope: bool = True, window: int = 0):
    """One-token decode. x: (B, 1, D); cache_{k,v}: (B, S_max, KV, dh).

    Returns (out, cache_k, cache_v). The caches are updated IN PLACE at
    ``cache_len`` (the JAX package returns new arrays; writing one slot
    saves copying the cache every token) and returned. Attention over the
    cache is linear in its length; slots past ``cache_len`` are masked."""
    B, _, D = x.shape
    hd = D // n_heads
    g = n_heads // n_kv_heads
    S_max = cache_k.shape[1]
    cache_len = int(cache_len)
    q = (x @ params["wq"]).reshape(B, 1, n_kv_heads * g, hd)
    k = (x @ params["wk"]).reshape(B, 1, n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, 1, n_kv_heads, hd)
    if use_rope:
        pos = torch.full((B, 1), cache_len, dtype=torch.int32,
                         device=x.device)
        q = apply_rope(q, pos, theta)
        k = apply_rope(k, pos, theta)
    cache_k[:, cache_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cache_len] = v[:, 0].to(cache_v.dtype)
    q = q.reshape(B, 1, n_kv_heads, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(),
                          cache_k.float()) / math.sqrt(hd)
    kpos = torch.arange(S_max, device=x.device)
    valid = kpos <= cache_len
    if window:
        valid &= kpos > cache_len - window
    scores = scores.masked_fill(~valid, -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, cache_v.to(w.dtype))
    return (out.reshape(B, 1, n_heads * hd) @ params["wo"], cache_k,
            cache_v)


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def mlp_init(key: torch.Tensor, d_model: int, d_ff: int, act: str,
             dtype: torch.dtype) -> dict:
    ks = prng.split(key, 3)
    p = {"wi": dense_init(ks[0], d_model, d_ff, dtype=dtype),
         "wo": dense_init(ks[1], d_ff, d_model, dtype=dtype)}
    if act == "swiglu":
        p["wg"] = dense_init(ks[2], d_model, d_ff, dtype=dtype)
    return p


def mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU (``silu(x @ wg) * (x @ wi)``) or GELU (JAX's default tanh
    approximation), then ``@ wo``."""
    h = x @ params["wi"]
    if act == "swiglu":
        h = F.silu(x @ params["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ params["wo"]
