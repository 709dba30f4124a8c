"""Decoder-only LM (dense and MoE, GQA, rotary) with a prefill path and a
KV-cache decode path: a port of ``repro.models.transformer``.

Params layout, the JAX package's (leaves under "layers" are stacked on a
leading L axis), as a dictionary of tensors:
  tok_embed (V, D)
  layers/ln1/..., layers/attn/{wq,wk,wv,wo}, layers/ln2/...,
  layers/mlp/{wi,wg,wo} or layers/moe/{gate,wi,wg,wo} (gate fp32)
  final_ln/..., head/w (D, V) unless the embeddings are tied

``init(cfg, seed)`` draws JAX's ``init(PRNGKey(seed), cfg)`` through
``common.prng``; ``params_from_jax``/``params_to_jax`` convert trees of
numpy arrays. The layers run one after another (the JAX package's
``scan`` over the stacked axis, or its unrolled loop, compute the same).
``mesh=`` (a ``DeviceMesh`` whose DTensors the parameters and tokens
are) puts the JAX package's constraints on the residual stream
(``_residual_kind``), the layers and the logits. ``loss_fn`` is the
training objective; when gradients are wanted, ``cfg.remat`` wraps each layer in an
activation checkpoint (its input and what ``cfg.remat_policy`` keeps
saved, the rest recomputed in the backward pass), as the JAX package's
``jax.checkpoint`` does; serving runs without one. Micro-batches belong to ``train.train_loop``. An MoE
config (``cfg.moe``) runs ``layers.moe`` in place of the MLP in
``forward`` and ``decode_step``; ``forward`` returns the sum of its
layers' load-balancing losses, which ``decode_step`` drops, as the JAX
package does.

``attn_impl`` picks the attention of ``forward``/``prefill``: ``"einsum"``
(the default, what the JAX package's LM computes) or ``"flash"``, the
``flash_attention`` kernel that the JAX package's attention layer offers
as ``attn_impl="flash"``. The serve step of ``launch.steps`` picks it
from what it sees (``layers.serve_attn_impl``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.config import LMConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (constrain, grad_like,
                                              is_dtensor, logsumexp,
                                              mesh_shape, onehot_like,
                                              replicate_like)
from repro_torch.models import layers as L


def init(cfg: LMConfig, seed: int = 0, device: DeviceLike = "cuda") -> dict:
    """Random parameters on ``device``: the JAX package's
    ``init(jax.random.PRNGKey(seed), cfg)``, key for key and leaf for leaf
    (``layers.stacked_layers``: the card holds the weights once, plus one
    layer's draw)."""
    dev = resolve_device(device)
    dt = L.compute_dtype(cfg.dtype)
    ks = prng.split(prng.key(seed, dev), 4)
    emb = (prng.normal(ks[0], (cfg.vocab_size, cfg.d_model)) * 0.02).to(dt)

    def layer_init(k):
        k1, k2 = prng.split(k)
        p = {
            "ln1": L.norm_init(cfg.norm, cfg.d_model, dev),
            "attn": L.attn_init(k1, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, dt),
            "ln2": L.norm_init(cfg.norm, cfg.d_model, dev),
        }
        if cfg.moe:
            p["moe"] = L.moe_init(k2, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                  dt)
        else:
            p["mlp"] = L.mlp_init(k2, cfg.d_model, cfg.d_ff, cfg.mlp_act, dt)
        return p

    params = {
        "tok_embed": emb,
        "layers": L.stacked_layers(prng.split(ks[1], cfg.n_layers),
                                   layer_init),
        "final_ln": L.norm_init(cfg.norm, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": L.dense_init(ks[2], cfg.d_model,
                                            cfg.vocab_size, dtype=dt)}
    return params


tree_map = L.tree_map


def params_from_jax(tree: dict, cfg: LMConfig,
                    device: DeviceLike = "cuda") -> dict:
    """A JAX-layout parameter tree (numpy or JAX arrays, bf16 included) as
    the port's dictionary on ``device``: norm parameters and the MoE
    router's ``gate`` fp32, every other matrix in the config's dtype, as
    the JAX package's ``init`` lays them out."""
    dev = resolve_device(device)
    dt = L.compute_dtype(cfg.dtype)

    def conv(path, x):
        fp32 = path[-1] in ("scale", "bias") or path[-2:] == ("moe", "gate")
        dtype = torch.float32 if fp32 else dt
        return torch.from_numpy(np.array(x, np.float32)).to(dev, dtype)

    def walk(path, t):
        if isinstance(t, dict):
            return {k: walk(path + (k,), v) for k, v in t.items()}
        return conv(path, t)

    return walk((), tree)


params_to_jax = L.tree_to_jax


def _ffn(cfg: LMConfig, p: dict, h: torch.Tensor, mesh=None,
         out_kind: str = "hidden"):
    """The layer's MLP, or its MoE FFN: ``(out, aux)``."""
    if cfg.moe:
        return L.moe(p["moe"], h, n_experts=cfg.n_experts,
                     top_k=cfg.moe_top_k, group_size=cfg.moe_group_size,
                     capacity_factor=cfg.moe_capacity_factor, mesh=mesh,
                     out_kind=out_kind, dispatch=cfg.moe_dispatch)
    return L.mlp(p["mlp"], h, cfg.mlp_act, mesh=mesh,
                 out_kind=out_kind), None


def _residual_kind(cfg: LMConfig, mesh, seq_len: int) -> str:
    """The residual stream's layout: ``"hidden_sp"`` (sequence-parallel:
    the carry sharded over the model axis too, all-gathered before
    attention and the FFN) or ``"hidden"``; JAX's rule, from the config's
    ``act_sharding`` and the mesh's sizes."""
    if cfg.act_sharding == "dp" or mesh is None:
        return "hidden"
    if cfg.act_sharding == "sp":
        return "hidden_sp"
    shape = mesh_shape(mesh)
    m = shape.get("model", 1)
    dp_total = shape.get("pod", 1) * shape.get("data", 1)
    if dp_total >= 32:
        # enough DP shards: SP's resharding costs more than it saves
        return "hidden"
    return "hidden_sp" if seq_len % m == 0 and seq_len >= m else "hidden"


def _layer(cfg: LMConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
           attn_impl: str, mesh=None, res_kind: str = "hidden"):
    """One layer: ``(x, aux)``, aux None for a dense layer."""
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    if res_kind == "hidden_sp":
        h = constrain(h, mesh, "hidden")   # SP all-gather before attention
    h = L.multihead_attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        causal=True, window=cfg.window if cfg.attention == "window" else 0,
        positions=positions, theta=cfg.rope_theta, mesh=mesh,
        attn_impl=attn_impl, out_kind=res_kind, q_chunk=cfg.attn_q_chunk,
        scores_dtype=L.compute_dtype(cfg.attn_scores_dtype))
    x = constrain(x + h, mesh, res_kind)
    h = L.apply_norm(cfg.norm, p["ln2"], x)
    if res_kind == "hidden_sp":
        h = constrain(h, mesh, "hidden")   # SP all-gather before the FFN
    h, aux = _ffn(cfg, p, h, mesh, res_kind)
    return constrain(x + h, mesh, res_kind), aux


def _logits(params: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """The vocab projection with fp32 results, as the JAX package's
    ``preferred_element_type=float32`` product (the bf16 inputs widened:
    their products are exact in fp32)."""
    head_w = (params["tok_embed"].T if cfg.tie_embeddings
              else params["head"]["w"])
    return torch.matmul(x.float(), head_w.float())


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            last_logit_only: bool = False, attn_impl: str = "einsum",
            mesh=None):
    """tokens: (B, S) int -> (logits (B, S, V) fp32, aux_loss).

    ``aux_loss`` is the sum of the MoE layers' load-balancing losses (0
    for a dense LM). ``last_logit_only`` (prefill serving): the vocab
    projection runs on the final position only. Under a ``mesh`` the
    logits are constrained to ``"logits"`` (vocab over the model axis),
    and the final norm's output to ``"hidden"`` (the port's own, ROADMAP
    C23)."""
    dt = L.compute_dtype(cfg.dtype)
    S = tokens.shape[1]
    res_kind = _residual_kind(cfg, mesh, S)
    x = constrain(_embed(params["tok_embed"], tokens).to(dt), mesh,
                  res_kind)
    positions = replicate_like(
        torch.arange(S, device=tokens.device)[None, :], x)
    auxs = []

    def layer(cfg, p, x):
        # a remat recompute appends again, after the sum below is taken
        x, aux = _layer(cfg, p, x, positions, attn_impl, mesh, res_kind)
        auxs.append(aux)
        return x

    x = L.run_layers(cfg, layer, params, x)
    # the sequence whole before the vocab product, as its "logits" layout
    # holds it (a sequence-parallel stream is gathered here)
    x = constrain(L.apply_norm(cfg.norm, params["final_ln"], x), mesh,
                  "hidden")
    if last_logit_only:
        x = x[:, -1:, :]
    aux = (torch.stack(auxs).sum() if cfg.moe else replicate_like(
        torch.zeros((), dtype=torch.float32, device=x.device), x))
    return constrain(_logits(params, x, cfg), mesh, "logits"), aux


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``. On a DTensor table (vocab over
    the model axis, d over the data axes) each rank looks its tokens up in
    its own block of the vocabulary, zeros where a token lies outside it,
    and the rows are summed over the vocab's mesh dims: a masked local
    lookup and an all-reduce of the (B, S, D) rows, as XLA partitions the
    JAX package's ``take``. The table is gathered only over the axes that
    split d (FSDP's gather, as for every weight), never over the vocab."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tokens = tokens if is_dtensor(tokens) else replicate_like(tokens, table)
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    t_pl = tuple(Shard(0) if v else Replicate() for v in vocab)
    ids_pl = tuple(Replicate() if v or not isinstance(p, Shard) else p
                   for v, p in zip(vocab, tokens.placements))
    rows_pl = tuple(Partial() if v else p for v, p in zip(vocab, ids_pl))
    grad_pl = tuple(Shard(0) if v else Partial() if isinstance(p, Shard)
                    else Replicate() for v, p in zip(vocab, ids_pl))
    n, off = compute_local_shape_and_global_offset(table.shape, mesh, t_pl)

    def look(block, ids):
        i = ids.long() - off[0]
        inside = ((i >= 0) & (i < n[0]))[..., None]
        return torch.where(inside, block[i.clamp(0, n[0] - 1)],
                           block.new_zeros(()))

    rows = local_map(look, out_placements=(rows_pl,),
                     in_placements=(t_pl, ids_pl),
                     in_grad_placements=(grad_pl, ids_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)
    return rows.redistribute(mesh, ids_pl)


def loss_fn(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: LMConfig, aux_weight: float = 0.01, mesh=None):
    """Mean next-token cross-entropy of ``forward``'s fp32 logits plus
    ``aux_weight`` times its aux loss: ``(loss, {"nll", "aux"})``, the
    metrics detached.

    The JAX package picks each label's logit by contracting a one-hot
    over V, so that a vocabulary sharded over its "model" axis is not
    all-gathered; under a ``mesh`` the port contracts it too, against a
    one-hot laid out as the logits (``sharding.onehot_like``), whose
    products take their gradient laid out as themselves
    (``sharding.grad_like``: a sum's gradient is a whole (B, S, V)
    tensor on every rank), and ``sharding.logsumexp`` keeps the
    vocabulary sharded too (ROADMAP C23). Without one a gather picks the
    same number (the one-hot sum adds only zeros to it, for finite
    logits) and saves the (B, S, V) fp32 one-hot: 3.3 GB at 8 x 2048
    tokens of olmo-1b (ROADMAP C18)."""
    logits, aux = forward(params, tokens, cfg, mesh=mesh)
    lse = logsumexp(logits)
    if is_dtensor(logits):
        picked = grad_like(logits * onehot_like(labels, logits)).sum(-1)
    else:
        picked = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = (lse - picked).mean()
    loss = nll + aux_weight * aux
    return loss, {"nll": nll.detach(), "aux": aux.detach()}


def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            attn_impl: str = "einsum", mesh=None) -> torch.Tensor:
    """Prefill forward (no cache write-back; returns last-position logits
    (B, 1, V) fp32)."""
    return forward(params, tokens, cfg, last_logit_only=True,
                   attn_impl=attn_impl, mesh=mesh)[0]


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = "cuda", mesh=None,
               spec: Optional[tuple] = None) -> dict:
    """Zero K and V caches (L, B, max_len, KV, dh). With a ``DeviceMesh``
    ``mesh`` and a ``spec`` (the step builders' ``_cache_sharding``) each
    is a DTensor of that layout, every rank holding only its block."""
    dt = dtype or L.compute_dtype(cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if mesh is not None:
        from torch.distributed.tensor import zeros as dzeros
        from repro_torch.distributed.sharding import to_placements
        pl = to_placements(spec or (), mesh)
        return {"k": dzeros(shape, dtype=dt, device_mesh=mesh,
                            placements=pl),
                "v": dzeros(shape, dtype=dt, device_mesh=mesh,
                            placements=pl)}
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def decode_step(params: dict, cache: dict, token: torch.Tensor,
                cache_len: int, cfg: LMConfig, mesh=None):
    """One decode step. token: (B, 1) int; cache_len: the number of filled
    slots (a Python int).

    Returns (logits (B, 1, V) fp32, cache). The cache is updated in place
    at slot ``cache_len`` of every layer and returned (the JAX package
    returns a new one). Attention is linear in the cache length. An MoE
    layer routes the B tokens of the step as one group (C = 1 at moonshot's
    B = 4, so tokens are dropped, as in the JAX package) and its aux loss
    is dropped."""
    dt = L.compute_dtype(cfg.dtype)
    x = _embed(params["tok_embed"], token).to(dt)
    for i, p in enumerate(L.unstack(params["layers"], cfg.n_layers)):
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        h, _, _ = L.decode_attention(
            p["attn"], h, cache["k"][i], cache["v"][i], cache_len,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            theta=cfg.rope_theta,
            window=cfg.window if cfg.attention == "window" else 0,
            mesh=mesh)
        x = x + h
        h = L.apply_norm(cfg.norm, p["ln2"], x)
        x = x + _ffn(cfg, p, h, mesh)[0]
    x = L.apply_norm(cfg.norm, params["final_ln"], x)
    return _logits(params, x, cfg), cache
