"""Configuration of the model families the port runs: the cheap ingest CNN,
the decoder-only LM (``LMConfig``), the vision transformers (``ViTConfig``:
ViT and DeiT), the diffusion transformer (``DiTConfig``) and EfficientNet
(``EffNetConfig``), each family with its shape cells, field for field the
JAX package's ``repro.common.config``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the dry-run grid.

    kind:
      train    -> lowers train_step            (LM)
      prefill  -> lowers prefill serve_step    (LM)
      decode   -> lowers 1-token decode serve_step with seq_len KV cache (LM)
      long     -> decode with a very long cache (sub-quadratic attn required)
      dit_train/dit_gen -> diffusion train / sampler loop
      cls      -> vision train step
      serve    -> vision inference forward
    """

    name: str
    kind: str
    seq_len: int = 0
    global_batch: int = 0
    img_res: int = 0
    steps: int = 0


@dataclass(frozen=True)
class LMConfig:
    """A decoder-only LM, field for field the JAX package's ``LMConfig``.

    ``remat`` and ``remat_policy`` hold: ``models.transformer.forward``
    checkpoints each layer's activations when gradients are wanted, under
    any of JAX's three policies (``models.layers.remat_policy``). The
    step builders (``launch.steps``) read the step-level fields:
    ``train_microbatches`` and ``grad_reduce_dtype`` in the train step,
    ``prefill_batch_chunks`` in the prefill step, whose long-prefill
    recipe also rewrites ``act_sharding`` and ``attn_q_chunk``
    (``attn_q_chunk`` sets the einsum route's query blocks;
    ``act_sharding`` picks the residual stream's layout on a mesh,
    ``transformer._residual_kind``). ``parallelism`` (``"ddp_zero1"``:
    replicated parameters, ZeRO-1 moments) sets the step builders'
    shardings on a mesh; ``scan_layers`` only names JAX's loop over the
    stacked layers (the port runs them one after another). The
    train loop of ``launch.train`` takes its micro-batches from
    ``TrainConfig``, as the JAX package's does. The MoE fields
    (``moe=True``) select ``models.layers.moe`` in place of the dense MLP:
    GShard dispatch over groups of ``moe_group_size`` tokens, in either
    ``moe_dispatch`` mode.
    """

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                      # per-expert width when moe=True
    vocab_size: int
    moe: bool = False
    n_experts: int = 0
    moe_top_k: int = 0
    moe_group_size: int = 1024     # GShard dispatch group size (tokens)
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "einsum"   # "einsum" (GShard baseline) | "scatter"
    norm: str = "rmsnorm"          # "rmsnorm" | "layernorm" | "nonparametric_ln"
    mlp_act: str = "swiglu"        # "swiglu" | "gelu"
    rope_theta: float = 10000.0
    attention: str = "full"        # "full" | "window"
    window: int = 0                # sliding-window size when attention=="window"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"
    scan_layers: bool = True
    act_sharding: str = "auto"
    train_microbatches: int = 1
    parallelism: str = "fsdp_tp"
    grad_reduce_dtype: str = "f32"
    attn_scores_dtype: str = "f32"  # "f32" | "bf16": score matrix precision
    attn_q_chunk: int = 4096        # query-block size: live scores shrink to
                                    # (B, H, q_chunk, S) per block
    prefill_batch_chunks: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def _per_layer_attn(self) -> int:
        d, hd = self.d_model, self.head_dim
        return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)

    def _rest(self) -> int:
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return emb + head + self.d_model

    def n_params(self) -> int:
        """Total parameter count (embedding included)."""
        d, f = self.d_model, self.d_ff
        if self.moe:
            mlp = self.n_experts * (3 * d * f) + d * self.n_experts
        else:
            n_mat = 3 if self.mlp_act == "swiglu" else 2
            mlp = n_mat * d * f
        norms = 2 * d if self.norm != "nonparametric_ln" else 0
        return (self.n_layers * (self._per_layer_attn() + mlp + norms)
                + self._rest())

    def n_active_params(self) -> int:
        """Parameters active per token (MoE top-k)."""
        if not self.moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        mlp = self.moe_top_k * (3 * d * f) + d * self.n_experts
        norms = 2 * d if self.norm != "nonparametric_ln" else 0
        return (self.n_layers * (self._per_layer_attn() + mlp + norms)
                + self._rest())


@dataclass(frozen=True)
class ViTConfig:
    """A ViT or DeiT image classifier, field for field the JAX package's.
    ``serve_pure_dp`` is read by the serve step (``launch.steps``), which
    on a mesh pads the batch to a multiple of its device count and
    spreads it over every axis; without a mesh, no pad. ``scan_layers``
    only names JAX's loop over the stacked layers: the port runs them
    one after another."""

    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    distill_token: bool = False    # DeiT
    in_channels: int = 3
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"
    scan_layers: bool = True
    serve_pure_dp: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def n_tokens(self, img_res: Optional[int] = None) -> int:
        res = img_res or self.img_res
        n = (res // self.patch) ** 2 + 1
        return n + (1 if self.distill_token else 0)

    def n_params(self) -> int:
        d, f = self.d_model, self.d_ff
        per_layer = 4 * d * d + 2 * d * f + 4 * d
        patch_embed = self.in_channels * self.patch ** 2 * d + d
        pos = self.n_tokens() * d
        head = d * self.n_classes + self.n_classes
        if self.distill_token:
            head *= 2
        return self.n_layers * per_layer + patch_embed + pos + head + 2 * d

    n_active_params = n_params


@dataclass(frozen=True)
class DiTConfig:
    """A latent diffusion transformer (adaLN-Zero), field for field the JAX
    package's; its latents are ``img_res // vae_factor`` pixels a side."""

    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    n_classes: int = 1000
    latent_channels: int = 4
    vae_factor: int = 8
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"
    scan_layers: bool = True

    @property
    def d_ff(self) -> int:
        return 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def n_tokens(self, img_res: Optional[int] = None) -> int:
        res = (img_res or self.img_res) // self.vae_factor
        return (res // self.patch) ** 2

    def n_params(self) -> int:
        d = self.d_model
        per_layer = 4 * d * d + 2 * d * self.d_ff + 6 * d * d + 2 * d
        io = self.latent_channels * self.patch ** 2 * d * 2
        cond = 256 * d + d * d + self.n_classes * d
        return self.n_layers * per_layer + io + cond

    n_active_params = n_params


@dataclass(frozen=True)
class EffNetConfig:
    """EfficientNet (MBConv + squeeze-excite, compound scaling), field for
    field the JAX package's. ``remat`` is kept so configs copy verbatim:
    neither package checkpoints EfficientNet's activations."""

    name: str
    img_res: int
    width_mult: float
    depth_mult: float
    n_classes: int = 1000
    dtype: str = "bfloat16"
    remat: bool = True

    def n_params(self) -> int:
        from repro_torch.models import efficientnet
        return efficientnet.count_params(self)

    n_active_params = n_params


@dataclass(frozen=True)
class CheapCNNConfig:
    """Focus ingest CNN: a small convnet (compressed family member).

    ``n_blocks`` plays the role of "number of conv layers kept" and
    ``input_res`` the rescaled input resolution — the two compression axes the
    paper uses (§4.1). ``n_classes`` shrinks under specialization (§4.3:
    Ls most-frequent classes + OTHER).
    """

    name: str
    input_res: int = 32
    n_blocks: int = 4
    width: int = 64
    n_classes: int = 1000
    feature_dim: int = 128        # penultimate-layer feature vector (clustering)
    in_channels: int = 3
    dtype: str = "float32"

    def flops_per_image(self) -> int:
        from repro_torch.models import cnn
        return cnn.flops_per_image(self)


# The widest cheap CNN of the benchmarks' generic family: with it the top-K
# index ranks all 1000 classes.
CHEAP_CNNS = {
    "cheap1": CheapCNNConfig("cheap1", input_res=32, n_blocks=6, width=48,
                             n_classes=1000, feature_dim=128),
}


LM_SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", seq_len=32768,
                             global_batch=32),
    "decode_32k": ShapeCell("decode_32k", "decode", seq_len=32768,
                            global_batch=128),
    "long_500k": ShapeCell("long_500k", "long", seq_len=524288,
                           global_batch=1),
}


DIT_SHAPES = {
    "train_256": ShapeCell("train_256", "dit_train", img_res=256,
                           global_batch=256, steps=1000),
    "gen_1024": ShapeCell("gen_1024", "dit_gen", img_res=1024,
                          global_batch=4, steps=50),
    "gen_fast": ShapeCell("gen_fast", "dit_gen", img_res=512,
                          global_batch=16, steps=4),
    "train_1024": ShapeCell("train_1024", "dit_train", img_res=1024,
                            global_batch=32, steps=1000),
}

VISION_SHAPES = {
    "cls_224": ShapeCell("cls_224", "cls", img_res=224, global_batch=256),
    "cls_384": ShapeCell("cls_384", "cls", img_res=384, global_batch=64),
    "serve_b1": ShapeCell("serve_b1", "serve", img_res=224, global_batch=1),
    "serve_b128": ShapeCell("serve_b128", "serve", img_res=224,
                            global_batch=128),
}


def shapes_for(cfg) -> dict:
    if isinstance(cfg, LMConfig):
        return LM_SHAPES
    if isinstance(cfg, DiTConfig):
        return DIT_SHAPES
    if isinstance(cfg, (ViTConfig, EffNetConfig)):
        return VISION_SHAPES
    raise TypeError(f"unknown config family: {type(cfg)}")


def reduced(cfg, **overrides):
    """A tiny same-family config for CPU smoke tests: the JAX package's
    ``reduced``, family for family."""
    if isinstance(cfg, LMConfig):
        base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    d_ff=128, vocab_size=256, moe_group_size=32, remat=False)
        if cfg.moe:
            base.update(n_experts=4, moe_top_k=2)
    elif isinstance(cfg, ViTConfig):
        base = dict(img_res=32, patch=8, n_layers=2, d_model=64, n_heads=4,
                    d_ff=128, n_classes=16, remat=False)
    elif isinstance(cfg, DiTConfig):
        base = dict(img_res=32, patch=2, n_layers=2, d_model=64, n_heads=4,
                    n_classes=16, remat=False)
    elif isinstance(cfg, EffNetConfig):
        base = dict(img_res=32, width_mult=0.25, depth_mult=0.25,
                    n_classes=16, remat=False)
    else:
        raise TypeError(type(cfg))
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
