"""ViT / DeiT image classifier (encoder-only transformer, learned pos-emb,
CLS token, optional DeiT distillation token): a port of
``repro.models.vit``. Variable input resolution through the pos-table
interpolation (the cls_384 cell). ``mesh=`` constrains the residual
stream as the JAX package does (``distributed.sharding``).

This family is the Focus GT-CNN (vit-l16) and the base of the compressed
cheap-CNN search space (vit-s16), as the paper's ResNet152 / ResNet18
variants are.

Params layout, the JAX package's (leaves under "layers" stacked on a
leading L axis), as a dictionary of tensors:
  patch/{w (p, p, C, D) HWIO, b}, cls (1, 1, D), pos_embed (1, T, D),
  layers/ln1/{scale, bias}, layers/attn/{wq,wk,wv,wo}, layers/ln2/...,
  layers/mlp/{wi,wo}, final_ln/..., head/{w, b}
  and, for DeiT, dist (1, 1, D) and head_dist/{w, b}

``init(cfg, seed)`` draws JAX's ``init(PRNGKey(seed), cfg)`` through
``common.prng``; the layer norms are fp32, every other leaf in the
config's dtype. Attention is non-causal, so it takes the einsum route of
``layers.multihead_attention``, as in the JAX package (whose flash route
is causal only). With gradients wanted, ``cfg.remat`` checkpoints each
layer (policy ``"nothing"``), as ``models.transformer`` does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common import prng
from repro_torch.common.config import ViTConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L


def init(cfg: ViTConfig, seed: int = 0, device: DeviceLike = "cuda") -> dict:
    """Random parameters on ``device``: the JAX package's
    ``init(jax.random.PRNGKey(seed), cfg)``, key for key."""
    dev = resolve_device(device)
    dt = L.compute_dtype(cfg.dtype)
    ks = prng.split(prng.key(seed, dev), 6)
    D = cfg.d_model

    def layer_init(k):
        k1, k2 = prng.split(k)
        return {
            "ln1": L.norm_init("layernorm", D, dev),
            "attn": L.attn_init(k1, D, cfg.n_heads, cfg.n_heads, dt),
            "ln2": L.norm_init("layernorm", D, dev),
            "mlp": L.mlp_init(k2, D, cfg.d_ff, "gelu", dt),
        }

    params = {
        "patch": L.patch_embed_init(ks[1], cfg.patch, cfg.in_channels, D,
                                    dt),
        "cls": torch.zeros((1, 1, D), dtype=dt, device=dev),
        "pos_embed": (prng.normal(ks[2], (1, cfg.n_tokens(), D))
                      * 0.02).to(dt),
        "layers": L.stacked_layers(prng.split(ks[0], cfg.n_layers),
                                   layer_init),
        "final_ln": L.norm_init("layernorm", D, dev),
        "head": {"w": L.dense_init(ks[3], D, cfg.n_classes, dtype=dt),
                 "b": torch.zeros(cfg.n_classes, dtype=dt, device=dev)},
    }
    if cfg.distill_token:
        params["dist"] = torch.zeros((1, 1, D), dtype=dt, device=dev)
        params["head_dist"] = {
            "w": L.dense_init(ks[4], D, cfg.n_classes, dtype=dt),
            "b": torch.zeros(cfg.n_classes, dtype=dt, device=dev)}
    return params


def params_from_jax(tree: dict, cfg: ViTConfig,
                    device: DeviceLike = "cuda") -> dict:
    """A JAX-layout parameter tree (numpy or JAX arrays) as the port's
    dictionary on ``device``, leaf dtypes as ``init`` makes them."""
    return L.tree_from_jax(tree, L.compute_dtype(cfg.dtype),
                           resolve_device(device))


def params_to_jax(params: dict) -> dict:
    """The port's parameters as a JAX-layout tree of float32 numpy arrays."""
    return L.tree_to_jax(params)


def _interp_pos(pos: torch.Tensor, n_special: int,
                n_patches_new: int) -> torch.Tensor:
    """Bilinear pos-embedding interpolation for a new resolution."""
    n_patches_old = pos.shape[1] - n_special
    if n_patches_old == n_patches_new:
        return pos
    g_old = int(math.sqrt(n_patches_old))
    g_new = int(math.sqrt(n_patches_new))
    special, grid = pos[:, :n_special], pos[:, n_special:]
    grid = L.resize_grid(grid.reshape(1, g_old, g_old, -1), g_new)
    grid = grid.reshape(1, g_new * g_new, -1).to(pos.dtype)
    return torch.cat([special, grid], dim=1)


def _layer(cfg: ViTConfig, p: dict, x: torch.Tensor,
           mesh=None) -> torch.Tensor:
    h = L.layernorm(p["ln1"], x)
    h = L.multihead_attention(p["attn"], h, n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_heads, causal=False,
                              use_rope=False, mesh=mesh)
    x = x + h
    h = L.layernorm(p["ln2"], x)
    return constrain(x + L.mlp(p["mlp"], h, "gelu", mesh=mesh), mesh,
                     "hidden")


def forward(params: dict, images: torch.Tensor, cfg: ViTConfig, mesh=None,
            *, features_only: bool = False) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, n_classes) fp32.

    ``features_only`` returns the penultimate (pre-head) CLS
    representation in fp32: the Focus feature vector used for clustering
    (§2.2.3 of the paper). DeiT's logits are the mean of its two heads'.
    Under a ``mesh`` the residual stream is constrained to ``"hidden"``,
    as in the JAX package."""
    dt = L.compute_dtype(cfg.dtype)
    x = L.patch_embed(params["patch"], images.to(dt), cfg.patch)
    B, N, D = x.shape
    toks = [params["cls"].expand(B, 1, D)]
    n_special = 1
    if cfg.distill_token:
        toks.append(params["dist"].expand(B, 1, D))
        n_special = 2
    x = torch.cat(toks + [x], dim=1)
    x = constrain(x + _interp_pos(params["pos_embed"], n_special, N), mesh,
                  "hidden")
    x = L.run_layers(cfg, _layer, params, x, mesh)
    x = L.layernorm(params["final_ln"], x)
    cls = x[:, 0]
    if features_only:
        return cls.float()
    logits = (cls @ params["head"]["w"] + params["head"]["b"]).float()
    if cfg.distill_token:
        hd = params["head_dist"]
        logits = (logits + (x[:, 1] @ hd["w"] + hd["b"]).float()) / 2
    return logits


def loss_fn(params: dict, images: torch.Tensor, labels: torch.Tensor,
            cfg: ViTConfig, mesh=None):
    return L.classification_loss(forward(params, images, cfg, mesh=mesh),
                                 labels)
