"""The neural-net layers of the port's models: norms, rotary embeddings,
GQA attention (prefill with causal/window masks, and one-token decode
against a KV cache), the dense MLP, the mixture-of-experts FFN, and the
vision primitives (patch embedding, convolution with JAX's ``"SAME"``
padding, batch norm with its running state, squeeze-excite).

A port of ``repro.models.layers``, with the JAX package's layouts at every
public function: parameters are dictionaries of tensors shaped as the JAX
tree (dense weights (d_in, d_out), applied as ``x @ w``; conv weights
HWIO), activations (B, S, D), heads (B, S, H, dh), images NHWC, a batch
norm's state ``{"mean", "var"}``. ``*_init`` draws through ``common.prng``
exactly as the JAX package draws through ``jax.random``. ``mesh=`` (a
``DeviceMesh``; None on one card) puts ``distributed.sharding.constrain``
at the JAX package's points: activations are DTensors there, and every
tensor a layer makes itself (positions, rope tables, masks, the MoE's
one-hots) joins x's mesh replicated (``sharding.replicate_like``). The
remat policies are JAX's three
(``remat_policy``): ``"nothing"`` a plain checkpoint per layer, ``"dots"``
and ``"dots_nobatch"`` torch's selective checkpointing, which keeps the
products that JAX's policy saves. ``serve_attn_impl`` is the serve
step's choice of attention route.

Matrix products stay ``torch.matmul``/``einsum``, as the JAX package
leaves them to XLA; the kernels of this module's path are
``hopper.ops.flash_attention`` on ``attn_impl="flash"`` and
``hopper.ops.topk``, the MoE router's top-k (``lax.top_k`` in the JAX
package: ties to the lowest expert, which ``torch.topk`` does not keep).
Where the JAX package asks a product for fp32 results from low-precision
inputs (``preferred_element_type=float32``), the port widens the inputs
to fp32 first: a product of two bf16 values is exact in fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.common import prng
from repro_torch.distributed.sharding import (by_rows, constrain,
                                              data_gathered, gathered,
                                              grad_like, heads_placements,
                                              is_dtensor, on_blocks,
                                              replicate_like,
                                              rows_placements, splits,
                                              unflatten, whole, write_slot)
from repro_torch.hopper import ops

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "bf16": torch.bfloat16, "f32": torch.float32}


_aten = torch.ops.aten
# the products JAX's policies see as dot_general (and, for "dots",
# conv_general_dilated), as torch dispatches them: ``x @ W`` folds to
# ``mm`` (or ``bmm`` against W expanded over the batch), an einsum is a
# ``bmm`` over its batch dims
_NO_BATCH = {_aten.mm.default, _aten.addmm.default}
_BATCHED = {_aten.bmm.default, _aten.baddbmm.default}
_CONV = {_aten.convolution.default}


def _no_batch_dims(func, args) -> bool:
    """Whether the product ``func(*args)`` has no batch dims in the JAX
    package's ``dot_general``: an ``mm``, or a ``bmm`` with an operand
    expanded over the batch (stride 0), which is how ``torch.matmul``
    multiplies a 3-D operand it cannot fold by a matrix. Any other
    ``bmm`` comes from an einsum whose batch dims JAX keeps as such
    (attention's heads, the MoE's groups and experts)."""
    if func in _NO_BATCH:
        return True
    operands = args[1:3] if func is _aten.baddbmm.default else args[:2]
    return func in _BATCHED and any(t.stride(0) == 0 for t in operands)


def _saves_dots(ctx, func, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots``: every product and
    convolution output saved, the rest recomputed."""
    return (CheckpointPolicy.MUST_SAVE
            if func in _NO_BATCH or func in _BATCHED or func in _CONV
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _saves_dots_nobatch(ctx, func, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: the outputs of products with
    no batch dims saved (projections, MLP, router), the rest recomputed."""
    return (CheckpointPolicy.MUST_SAVE if _no_batch_dims(func, args)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(name: str):
    """The activation-checkpoint policy of ``cfg.remat_policy``, as the
    JAX package names them: ``None`` for ``"nothing"`` (every config's:
    a plain ``torch.utils.checkpoint.checkpoint`` around the layer, which
    saves its input and recomputes the rest), else the policy function
    of torch's selective checkpointing: ``"dots"`` saves every product's
    output (the fp32 attention scores among them, as JAX does),
    ``"dots_nobatch"`` only those of products with no batch dims."""
    if name == "nothing":
        return None
    if name == "dots":
        return _saves_dots
    if name == "dots_nobatch":
        return _saves_dots_nobatch
    raise ValueError(name)


def run_layers(cfg, layer, params: dict, x: torch.Tensor, *args):
    """``layer(cfg, p, x, *args)`` over the stacked layers
    ``params["layers"]`` in order: the JAX package's ``scan`` over the
    stacked axis. With gradients wanted and ``cfg.remat``, each layer runs
    under an activation checkpoint (``remat_policy(cfg.remat_policy)``)
    that saves its input, and what the policy saves, and recomputes the
    rest in the backward pass; serving runs without one. Every policy
    computes the same numbers: a recomputed op gives the bits it gave."""
    remat = (cfg.remat and torch.is_grad_enabled()
             and any(t.requires_grad for t in tree_leaves(params)))
    kw = {}
    if remat:
        policy = remat_policy(cfg.remat_policy)
        if policy is not None:
            kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
                policy)
    for p in unstack(params["layers"], cfg.n_layers):
        if remat:
            # the layers draw no random numbers: no RNG state to replay
            x = checkpoint(layer, cfg, p, x, *args, use_reentrant=False,
                           preserve_rng_state=False, **kw)
        else:
            x = layer(cfg, p, x, *args)
    return x


def serve_attn_impl(x: torch.Tensor, head_dim: int, causal: bool = True,
                    window: int = 0) -> str:
    """The serve step's attention route for activations ``x``:
    ``"flash"`` (the ``flash_attention`` kernel) when the attention is
    causal without a window, the head width is one the kernel is built
    for (``hopper.ops.FLASH_HEAD_DIMS``) and ``x`` lies on the card; else
    ``"einsum"``. The JAX package's serve step takes the einsum route
    everywhere; the kernel is the port of its own Pallas kernel (ROADMAP
    C17). A DTensor's ``is_cuda`` is its local tensor's."""
    if (causal and not window and head_dim in ops.FLASH_HEAD_DIMS
            and x.is_cuda):
        return "flash"
    return "einsum"


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
    freqs = replicate_like(rope_freqs(dh, theta, x.device), x)
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
                        mesh=None, attn_impl: str = "einsum",
                        out_kind: str = "hidden", q_chunk: int = 4096,
                        scores_dtype: torch.dtype = torch.float32):
    """Self attention over x: (B, S, D). Returns (B, S, D).

    ``attn_impl="flash"`` (causal, no window) runs the ``flash_attention``
    kernel on K/V repeated to every head; otherwise the einsum route:
    fp32 (or ``scores_dtype``) scores, causal keys past a query block
    sliced off rather than masked, and query blocks of ``q_chunk`` rows
    when S is a larger multiple of it. Under a ``mesh`` the einsum route
    constrains q/k/v to ``"heads"``, attends on each rank's block of
    batch and heads (``sharding.on_blocks``, as the flash route's
    kernel does), and constrains the heads' output to ``"ffn"`` and the
    result to ``out_kind``; the flash route constrains nothing, as in
    JAX."""
    B, S, D = x.shape
    hd = D // n_heads
    g = n_heads // n_kv_heads
    q = unflatten(x @ params["wq"], -1, (n_kv_heads * g, hd))
    k = unflatten(x @ params["wk"], -1, (n_kv_heads, hd))
    v = unflatten(x @ params["wv"], -1, (n_kv_heads, hd))
    if use_rope:
        if positions is None:
            positions = replicate_like(
                torch.arange(S, device=x.device)[None, :], x)
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
    q = constrain(q, mesh, "heads")
    kf = constrain(kf, mesh, "heads")
    vf = constrain(vf, mesh, "heads")

    def attend(ql, kl, vl):
        return _attend(ql, kl, vl, causal=causal, window=window,
                       q_chunk=q_chunk, scores_dtype=scores_dtype,
                       out_dtype=x.dtype)
    # on a mesh each rank attends its own (batch, heads) block: the
    # scores and weights are JAX's "scores" layout by construction
    out = (on_blocks(attend, heads_placements(q), q, kf, vf)
           if is_dtensor(q) else attend(q, kf, vf))
    out = constrain(out.reshape(B, S, n_heads * hd), mesh, "ffn")
    return constrain(out @ params["wo"], mesh, out_kind)


def _attend(q: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, *,
            causal: bool, window: int, q_chunk: int,
            scores_dtype: torch.dtype, out_dtype: torch.dtype):
    """The einsum route's softmax(q . k^T) . v on (B, S, H, dh) tensors,
    in query blocks of ``q_chunk`` rows when S is a larger multiple of
    it; each causal block attends only the keys up to its last row."""
    S, hd, dev = q.shape[1], q.shape[-1], q.device
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
                                  device=dev).tril()
                s = torch.cat([s[..., :q0],
                               s[..., q0:].masked_fill(~diag, neg)], dim=-1)
            else:
                qpos = q0 + torch.arange(Sq, device=dev)[:, None]
                kpos = torch.arange(Sk, device=dev)[None, :]
                mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
                if causal:
                    mask &= kpos <= qpos
                if window:
                    mask &= kpos > qpos - window
                s = s.masked_fill(~mask, neg)
        w = torch.softmax(s, dim=-1).to(out_dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, vv.to(w.dtype))

    if q_chunk and S > q_chunk and S % q_chunk == 0:
        outs = []
        for q0 in range(0, S, q_chunk):
            k_end = q0 + q_chunk if (causal and not window) else None
            outs.append(attend(q[:, q0:q0 + q_chunk], q0, q_chunk,
                               k_end=k_end))
        return torch.cat(outs, dim=1)
    return attend(q, 0, S)


def decode_attention(params: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len: int, *, n_heads: int,
                     n_kv_heads: int, theta: float = 10000.0,
                     use_rope: bool = True, window: int = 0, mesh=None):
    """One-token decode. x: (B, 1, D); cache_{k,v}: (B, S_max, KV, dh).

    Returns (out, cache_k, cache_v). The caches are updated IN PLACE at
    ``cache_len`` (the JAX package returns new arrays; writing one slot
    saves copying the cache every token) and returned; a DTensor cache
    is written per rank, also where its sequence is sharded
    (``sharding.write_slot``), and attended per rank where it is not.
    Attention over the cache is linear in its length; slots past
    ``cache_len`` are masked. ``mesh`` is the JAX package's argument,
    and as there decode sets no constraint: the layout follows the
    cache's and the weights'."""
    B, _, D = x.shape
    hd = D // n_heads
    g = n_heads // n_kv_heads
    S_max = cache_k.shape[1]
    cache_len = int(cache_len)
    q = unflatten(x @ params["wq"], -1, (n_kv_heads * g, hd))
    k = unflatten(x @ params["wk"], -1, (n_kv_heads, hd))
    v = unflatten(x @ params["wv"], -1, (n_kv_heads, hd))
    if use_rope:
        pos = replicate_like(torch.full((B, 1), cache_len, dtype=torch.int32,
                                        device=x.device), x)
        q = apply_rope(q, pos, theta)
        k = apply_rope(k, pos, theta)
    write_slot(cache_k, cache_len, k[:, 0])
    write_slot(cache_v, cache_len, v[:, 0])
    q = unflatten(q, 2, (n_kv_heads, g))

    def attend(q, cache_k, cache_v):
        scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(),
                              cache_k.float()) / math.sqrt(hd)
        kpos = torch.arange(S_max, device=q.device)
        valid = kpos <= cache_len
        if window:
            valid &= kpos > cache_len - window
        scores = scores.masked_fill(~replicate_like(valid, scores), -1e30)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        return torch.einsum("bkgqs,bskd->bqkgd", w, cache_v.to(w.dtype))

    if is_dtensor(cache_k) and not splits(cache_k, 1):
        # each rank's block of the cache holds whole sequences: attend on
        # it, q laid out as the cache (DTensor's own einsum costs seconds
        # of planning per new layout)
        out = on_blocks(attend, cache_k.placements, q, cache_k, cache_v)
    else:
        out = attend(q, cache_k, cache_v)
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


def mlp(params: dict, x: torch.Tensor, act: str, mesh=None,
        out_kind: str = "hidden") -> torch.Tensor:
    """SwiGLU (``silu(x @ wg) * (x @ wi)``) or GELU (JAX's default tanh
    approximation), then ``@ wo``. Under a ``mesh`` a 3-D x keeps the wide
    products on ``"ffn"`` and the output on ``out_kind``."""
    three_d = x.dim() == 3
    h = x @ params["wi"]
    if three_d:
        h = constrain(h, mesh, "ffn")
    if act == "swiglu":
        g = x @ params["wg"]
        if three_d:
            g = constrain(g, mesh, "ffn")
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    out = h @ params["wo"]
    return constrain(out, mesh, out_kind) if three_d else out


# ---------------------------------------------------------------------------
# MoE (GShard-style grouped dispatch)
# ---------------------------------------------------------------------------

def moe_init(key: torch.Tensor, d_model: int, d_ff: int, n_experts: int,
             dtype: torch.dtype) -> dict:
    """The router ``gate`` (D, E) in fp32 whatever ``dtype`` is, and the
    SwiGLU experts ``wi``/``wg`` (E, D, F) and ``wo`` (E, F, D), drawn in
    fp32 and cast: the JAX package's ``moe_init``, key for key."""
    ks = prng.split(key, 4)
    s = 1.0 / math.sqrt(d_model)

    def ew(k, a, b, sc):
        return (prng.normal(k, (n_experts, a, b)) * sc).to(dtype)

    return {
        "gate": dense_init(ks[0], d_model, n_experts, dtype=torch.float32),
        "wi": ew(ks[1], d_model, d_ff, s),
        "wg": ew(ks[2], d_model, d_ff, s),
        "wo": ew(ks[3], d_ff, d_model, 1.0 / math.sqrt(d_ff)),
    }


def moe_groups(n_tokens: int, group_size: int, top_k: int,
               capacity_factor: float, n_experts: int):
    """(group size gs, groups G, capacity C) of ``n_tokens`` tokens: gs is
    ``group_size`` (at most ``n_tokens``) halved until it divides them,
    and C = ceil(gs·k·cf/E), at least 1 and at most gs."""
    gs = min(group_size, n_tokens)
    while n_tokens % gs:
        gs //= 2
    C = max(1, int(math.ceil(gs * top_k * capacity_factor / n_experts)))
    return gs, n_tokens // gs, min(C, gs)


def moe_route(gate: torch.Tensor, xg: torch.Tensor, top_k: int,
              capacity: int):
    """The router of ``moe`` on grouped tokens xg (G, gs, D): returns
    ``(probs (G, gs, E) fp32, idx (G, gs, k) int64, gate_vals (G, gs, k)
    fp32, within (G, gs, k) int64, keep (G, gs, k) bool)``.

    fp32 logits ``xg @ gate`` and their softmax; each token's k experts
    by probability, descending, ties to the lowest expert index (JAX's
    ``lax.top_k``; ``torch.topk`` keeps no tie rule), ranked by
    ``hopper.ops.topk``: one launch over the (G·gs, E) probabilities on
    the card. The gate values are gathered from ``probs`` so that
    gradients reach the router, renormalised over the k, and zeroed where
    the token is dropped. Slots: choice 0 of every token in the group
    before choice 1, and so on; ``within`` is the choice's position in
    its expert's buffer, ``keep`` = ``within < capacity``."""
    G, gs, _ = xg.shape
    # the (D, E) router weight whole (FSDP's gather), so that the product
    # keeps the groups' layout (DTensor would otherwise split the tokens
    # to meet the weight's d_model split, and cannot fold them back)
    logits = torch.matmul(xg.float(), gathered(gate))
    probs = torch.softmax(logits, dim=-1)
    E = probs.shape[-1]
    _, idx = ops.topk(probs.detach().reshape(G * gs, E), top_k)
    idx = idx.long().reshape(G, gs, top_k)
    gate_vals = probs.gather(-1, idx)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    # priority order (G, k·gs): choice 0 of all tokens first. The one-hot
    # is laid out (G, E, k·gs), so that the running count is a scan along
    # contiguous rows (over the middle axis of (G, k·gs, E), CUDA's scan
    # took 2 ms a layer at moonshot's prefill)
    order = idx.transpose(1, 2).reshape(G, 1, top_k * gs)
    experts = replicate_like(
        torch.arange(E, device=idx.device)[None, :, None], idx)
    oh = (order == experts).to(torch.int32)
    pos = (oh.cumsum(-1, dtype=torch.int32) - oh).gather(1, order)
    within = pos.reshape(G, top_k, gs).transpose(1, 2).long()
    keep = within < capacity
    return probs, idx, gate_vals * keep, within, keep


def _slot_table(idx: torch.Tensor, c_ix: torch.Tensor, vals: torch.Tensor,
                n_experts: int, capacity: int) -> torch.Tensor:
    """(G, gs, E, C) zeros holding each token's choice values at (group,
    token, its expert, its slot): GShard's dispatch or combine tensor;
    idx, c_ix, vals (G, gs, k)."""
    G, gs, _ = idx.shape
    g_ix = torch.arange(G, device=idx.device)[:, None, None]
    s_ix = torch.arange(gs, device=idx.device)[None, :, None]
    return vals.new_zeros((G, gs, n_experts, capacity)).index_put(
        (g_ix, s_ix, idx, c_ix), vals)


def moe(params: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
        group_size: int, capacity_factor: float, mesh=None,
        out_kind: str = "hidden", dispatch: str = "einsum"):
    """Mixture-of-experts FFN. x: (B, S, D) -> (y, aux_loss).

    The tokens are cut into G groups of gs (``moe_groups``); each group
    routes (``moe_route``) into per-expert buffers of C slots, the
    experts run SwiGLU on their (G, C) slots, and each token sums its
    kept experts' outputs weighted by its gate values. Tokens past an
    expert's capacity are dropped, as in the JAX package (a decode step
    of 4 tokens has C = 1). ``aux_loss`` is the Switch/GShard
    load-balancing loss, E·Σ mean(probs)·mean(one_hot(choice 0)).

    ``dispatch="einsum"``: the (G, gs, E, C) dispatch and combine tensors
    and GShard's two einsums. A token's k choices go to k different
    experts, so each (e, c) slot of a token holds at most one choice and
    both tensors are written by indexing rather than as the JAX
    package's (G, gs, k, E, C) product summed over k; with one nonzero
    term per output, the dispatch product is exact. ``"scatter"``: the
    tokens added into an (E, G, C + 1, D) buffer whose last slot takes
    the dropped ones and is cut off (JAX's ``.at[].add(mode="drop")``),
    and gathered back at ``min(within, C - 1)`` with their gate values.
    The expert products stay ``torch.einsum``, as the JAX package leaves
    them to XLA. Under a ``mesh`` the output is constrained to
    ``out_kind``, and, the port's own (ROADMAP C23), the groups to
    ``"groups"``, the expert buffers to ``"experts"`` and the experts'
    outputs to ``"expert_groups"``: GShard's all-to-alls between them;
    the experts' weights are gathered over the data axes before their
    products (FSDP's all-gather, ROADMAP C26)."""
    B, S, D = x.shape
    gs, G, C = moe_groups(B * S, group_size, top_k, capacity_factor,
                          n_experts)
    xg = constrain(unflatten(x.flatten(0, 1), 0, (G, gs)), mesh, "groups")
    probs, idx, gate_vals, within, keep = moe_route(params["gate"], xg,
                                                    top_k, C)
    me = probs.mean((0, 1))
    ce = F.one_hot(idx[..., 0], n_experts).float().mean((0, 1))
    aux = n_experts * (me * ce).sum()

    if dispatch == "einsum":
        c_ix = within.clamp(max=C - 1)     # a dropped choice writes 0

        def table(vals):
            # on a mesh each rank writes its own block of groups
            fn = lambda i, c, v: _slot_table(i, c, v, n_experts, C)
            if is_dtensor(idx):
                return on_blocks(fn, rows_placements(idx), idx, c_ix, vals)
            return fn(idx, c_ix, vals)

        disp = table(keep.to(x.dtype))
        comb = table(gate_vals.to(x.dtype))
        exp_in = torch.einsum("gsec,gsd->egcd", disp, xg)
    elif dispatch == "scatter":
        g_ix = replicate_like(
            torch.arange(G, device=x.device)[:, None, None], x)
        c_ix = torch.where(keep, within, C)
        exp_in = x.new_zeros((n_experts, G, C + 1, D)).index_put(
            (idx, g_ix, c_ix), xg[:, :, None, :].expand(G, gs, top_k, D),
            accumulate=True)[:, :, :C]
    else:
        raise ValueError(f"dispatch must be 'einsum' or 'scatter', got "
                         f"{dispatch!r}")

    exp_in = constrain(exp_in, mesh, "experts")
    # the experts' weights whole over the data axes (FSDP's gather, their
    # gradients reduce-scattered back; ROADMAP C26): no product contracts
    # a split dimension, so h, hg and the output come out whole, laid out
    # as exp_in
    wi, wg, wo = (data_gathered(params[k]) for k in ("wi", "wg", "wo"))
    h = torch.einsum("egcd,edf->egcf", exp_in, wi)
    hg = torch.einsum("egcd,edf->egcf", exp_in, wg)
    exp_out = torch.einsum("egcf,efd->egcd", F.silu(hg) * h, wo)
    # already "experts"; then the experts' all-to-all onto the groups
    # (ROADMAP C24)
    for kind in ("experts", "expert_groups"):
        exp_out = constrain(exp_out, mesh, kind)

    if dispatch == "einsum":
        # laid out as the groups, its gradient too: the combine's backward
        # then runs on the same blocks as its forward
        y = grad_like(constrain(torch.einsum("egcd,gsec->gsd", exp_out,
                                             comb), mesh, "groups"))
    else:
        picked = exp_out[idx, g_ix, within.clamp(max=C - 1)]
        y = (picked * gate_vals[..., None].to(x.dtype)).sum(2)
    return constrain(unflatten(y.flatten(0, 1), 0, (B, S)), mesh,
                     out_kind), aux


# ---------------------------------------------------------------------------
# Vision primitives (images NHWC, conv weights HWIO, as in the JAX package)
# ---------------------------------------------------------------------------

def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` element by element, correctly rounded in x's dtype: a
    tensor divisor, so no backend turns it into a product with ``1/d``
    (XLA divides these draws)."""
    return x / torch.full_like(x, d)


def patch_embed_init(key: torch.Tensor, patch: int, in_ch: int,
                     d_model: int, dtype: torch.dtype) -> dict:
    k1, _ = prng.split(key)
    fan_in = patch * patch * in_ch
    w = _div(prng.normal(k1, (patch, patch, in_ch, d_model)),
             math.sqrt(fan_in)).to(dtype)
    return {"w": w, "b": torch.zeros(d_model, dtype=dtype,
                                     device=key.device)}


def patch_embed(params: dict, images: torch.Tensor,
                patch: int) -> torch.Tensor:
    """images: (B, H, W, C) -> (B, H/p * W/p, D): the VALID convolution of
    stride ``patch``, plus the bias."""
    out = conv(params, images, stride=patch, padding="VALID") + params["b"]
    B, Hp, Wp, D = out.shape
    return out.reshape(B, Hp * Wp, D)


def conv_init(key: torch.Tensor, kh: int, kw: int, cin: int, cout: int,
              dtype: torch.dtype, groups: int = 1) -> dict:
    fan_in = kh * kw * cin // groups
    w = _div(prng.normal(key, (kh, kw, cin // groups, cout)),
             math.sqrt(max(fan_in, 1)))
    return {"w": w.to(dtype)}


def same_pads(size: int, k: int, stride: int):
    """JAX's ``"SAME"`` padding of one axis: the output is
    ``ceil(size / stride)`` long, and the padding it needs goes
    ``total // 2`` before and the rest after (so a stride of 2 pads one
    more after than before, where ``F.conv2d(padding=...)`` pads both
    sides alike)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(params: dict, x: torch.Tensor, stride: int = 1, groups: int = 1,
         padding: str = "SAME") -> torch.Tensor:
    """The JAX package's ``conv``: x (B, H, W, Cin) NHWC, ``params["w"]``
    (kh, kw, Cin/groups, Cout) HWIO, ``padding`` ``"SAME"`` or ``"VALID"``
    -> (B, H', W', Cout). Runs as ``F.conv2d`` on the channels-last view
    of x (no copy of x), the weights permuted to OIHW; asymmetric SAME
    padding is added to the NHWC tensor first. On a mesh each rank
    convolves its block of the batch (``sharding.by_rows``)."""
    if is_dtensor(x):
        return by_rows(lambda xl, wl: conv({"w": wl}, xl, stride, groups,
                                           padding), x, params["w"])
    w = params["w"]
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        (t, b), (lf, r) = (same_pads(x.shape[1], kh, stride),
                           same_pads(x.shape[2], kw, stride))
    elif padding == "VALID":
        t = b = lf = r = 0
    else:
        raise ValueError(f"padding {padding!r}: 'SAME' or 'VALID'")
    sym = (t, lf) if (t == b and lf == r) else (0, 0)
    if sym == (0, 0) and (t, b, lf, r) != (0, 0, 0, 0):
        x = F.pad(x, (0, 0, lf, r, t, b))
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=stride, padding=sym, groups=groups)
    return out.permute(0, 2, 3, 1)


def resize_grid(grid: torch.Tensor, g_new: int) -> torch.Tensor:
    """A (1, g, g, D) table resized to (1, g_new, g_new, D) in fp32, as
    ``jax.image.resize(..., "bilinear")``: half-pixel centres, and a
    triangle kernel widened by the scale when it shrinks (``antialias``),
    which ``F.interpolate(mode="bilinear")`` does only with
    ``antialias=True``. A DTensor table is resized on each rank's block
    of channels (the resize mixes no channels; DTensor has no rule for
    it on every torch)."""
    if is_dtensor(grid):
        from torch.distributed.tensor import Replicate, Shard
        pl = tuple(p if isinstance(p, Shard) and p.dim == 3 else Replicate()
                   for p in grid.placements)
        return on_blocks(lambda g: resize_grid(g, g_new), pl, grid)
    out = F.interpolate(grid.float().permute(0, 3, 1, 2),
                        size=(g_new, g_new), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy of fp32 logits and the accuracy: ``(loss,
    {"nll", "acc"})``, the metrics detached."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0].mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, {"nll": nll.detach(), "acc": acc.detach()}


def bn_init(c: int, device=None):
    """(params ``{"scale", "bias"}``, state ``{"mean", "var"}``), fp32."""
    ones = torch.ones(c, device=device)
    zeros = torch.zeros(c, device=device)
    return ({"scale": ones, "bias": zeros},
            {"mean": zeros.clone(), "var": ones.clone()})


def batchnorm(params: dict, state: dict, x: torch.Tensor, train: bool,
              momentum: float = 0.99, eps: float = 1e-3):
    """The JAX package's batch norm over (B, H, W) of x (B, H, W, C):
    ``(y, new_state)``. Not ``nn.BatchNorm2d``: in training the state
    keeps ``momentum * old + (1 - momentum) * batch`` with the batch's
    biased variance, and ``eps`` is 1e-3. In eval the state normalises
    and is returned as it is. The statistics and the normalisation run
    in fp32; y is cast back to x's dtype."""
    xf = x.float()
    if train:
        if is_dtensor(xf):
            # the JAX package's two means (jnp.mean, jnp.var), which
            # DTensor reduces over a sharded batch on every torch; plain
            # tensors keep var_mean's one pass (the two means cost
            # efficientnet-b7's training 20-43% on the card). Each mean
            # is made whole before it meets x: torch 2.13's DTensor meets
            # a partial mean by turning x's batch shard into a partial
            # sum, a whole-batch block on every rank (ROADMAP C25)
            mean = whole(xf.mean((0, 1, 2)))
            var = whole((xf - mean).square().mean((0, 1, 2)))
        else:
            var, mean = torch.var_mean(xf, dim=(0, 1, 2), unbiased=False)
        new_state = {
            "mean": momentum * state["mean"] + (1 - momentum) * mean,
            "var": momentum * state["var"] + (1 - momentum) * var,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"] + params["bias"]
    return y.to(x.dtype), new_state


def se_init(key: torch.Tensor, c: int, c_se: int,
            dtype: torch.dtype) -> dict:
    k1, k2 = prng.split(key)
    return {"w1": dense_init(k1, c, c_se, dtype=dtype),
            "b1": torch.zeros(c_se, dtype=dtype, device=key.device),
            "w2": dense_init(k2, c_se, c, dtype=dtype),
            "b2": torch.zeros(c, dtype=dtype, device=key.device)}


def squeeze_excite(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) scaled per channel by
    ``sigmoid(silu(mean_hw(x) @ w1 + b1) @ w2 + b2)``."""
    s = x.mean((1, 2))
    s = F.silu(s @ params["w1"] + params["b1"])
    s = torch.sigmoid(s @ params["w2"] + params["b2"])
    return x * s[:, None, None, :]


# ---------------------------------------------------------------------------
# Parameter trees (dicts and lists of tensors, as the JAX package nests them)
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts, lists and tuples,
    as ``jax.tree.map`` does: e.g. ``tree_map(lambda t: t.cpu(),
    params)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts in the JAX package's order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def write_layer(stacked: dict, layer: dict, i: int):
    """Copies one layer's tree into row ``i`` of the stacked tree."""
    for k, v in layer.items():
        if isinstance(v, dict):
            write_layer(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


def stacked_layers(keys: torch.Tensor, layer_init) -> dict:
    """The JAX package's ``vmap(layer_init)(keys)``: one draw per layer key
    (threefry draws per key alike under ``vmap``), each written into
    leaves with a leading layer axis, allocated once, as it is made."""
    stacked = None
    n = keys.shape[0]
    for i, k in enumerate(keys):
        p = layer_init(k)
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty((n,) + t.shape), p)
        write_layer(stacked, p, i)
        del p                   # the next layer's draw runs without it
    return stacked


def unstack(tree: dict, n: int) -> list:
    """The stacked layer tree as ``n`` per-layer trees of views. One
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing each layer would add a full-size zero gradient per
    layer."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


def tree_from_jax(tree, dtype: torch.dtype, device: torch.device):
    """A JAX-layout tree (numpy or JAX arrays, bf16 included) as tensors on
    ``device``: norm and batch-norm leaves (``scale``, ``bias``, ``mean``,
    ``var``) fp32, every other leaf in ``dtype``, as the JAX package's
    ``init`` lays them out."""
    def walk(key, t):
        if isinstance(t, dict):
            return {k: walk(k, v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(key, v) for v in t]
        dt = (torch.float32 if key in ("scale", "bias", "mean", "var")
              else dtype)
        return torch.from_numpy(np.array(t, np.float32)).to(device, dt)

    return walk(None, tree)


def tree_to_jax(tree):
    """A tree of tensors as float32 numpy arrays (numpy has no bfloat16; a
    bf16 value is exact in float32)."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)
