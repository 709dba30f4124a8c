"""Step builders: (arch, shape cell) -> a step function and its abstract
inputs, for the trainer and the server on one card. A port of
``repro.launch.steps``.

Every builder returns a ``StepSpec`` whose ``args`` are meta tensors
(shapes and dtypes, no storage), leaf for leaf the JAX spec's
``ShapeDtypeStruct``s in the port's tree layout: parameters as each
model's ``init`` lays them out (drawn on ``device="meta"``, which costs
nothing), AdamW's state as ``train.optimizer.init`` makes it (its
``step`` a Python int), a decode step's ``cache_len`` a Python int, as
``transformer.decode_step`` takes one. Call ``spec.fn`` on real tensors
of those shapes, on the card or on the CPU:

  spec = build("olmo-1b", "prefill_32k")
  logits = spec.fn(params, tokens)       # params from transformer.init

No mesh: one card has no shardings, so a ``StepSpec`` has no
``in_shardings``/``out_shardings`` (they come with the multi-card slice,
ROADMAP A14), and ``donate_argnums`` names the arguments the step updates
in place: a train step's parameters and optimizer state, a decode step's
cache (C10). The steps compute what the JAX package's do:

- train: the loss's gradients accumulated over ``cfg.train_microbatches``
  contiguous parts in fp32 and divided by their count (the train loop's
  ``make_train_step``, the same arithmetic), cast to
  ``cfg.grad_reduce_dtype``, then one AdamW step of ``OPT_CFG``;
  ``(params, opt_state, loss)``;
- prefill: the batch in ``prefill_batch_chunks`` parts one after another
  (the long-prefill recipe of the JAX package at d_model >= 6144 and
  S >= 32768: halves, 1024-row query blocks), the attention route chosen
  from what the step sees (``layers.serve_attn_impl``: the
  ``flash_attention`` kernel on the card, ROADMAP C17);
- decode and long: ``transformer.decode_step`` on a cache of the cell's
  length; ``long`` with full attention is skipped with the JAX package's
  reason, and ``build_lm_long_window`` builds its window variant;
- DiT: training at the cell's resolution and ``dit.sample`` with the
  cell's steps, the (2,) uint32 seed read as a ``common.prng`` key;
- ViT/DeiT and EfficientNet: training and serving (EfficientNet's train
  step returns the new batch-norm state; serving runs ``train=False``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.common.config import (DiTConfig, EffNetConfig, LMConfig,
                                       ShapeCell, ViTConfig)
from repro_torch.configs import get_arch, get_shapes
from repro_torch.models import dit, efficientnet, layers, transformer, vit
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                          param_leaves)

OPT_CFG = opt.OptConfig(lr=3e-4, warmup_steps=2000, total_steps=100000)

# ``grad_reduce_dtype`` as the train loop's compression: the bf16 wire
# format's round trip, or none (fp32 gradients go to AdamW as they are)
_REDUCE = {"f32": "none", "bf16": "bf16"}


@dataclass
class StepSpec:
    name: str
    fn: Optional[Callable]
    args: Tuple[Any, ...]          # trees of meta tensors (and Python ints)
    donate_argnums: Tuple[int, ...] = ()
    skip_reason: Optional[str] = None   # set for inapplicable cells


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _opt_state(p_shapes):
    return opt.init(param_leaves(p_shapes))


def _key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.wrap_key_data`` of a (2,) uint32 seed: the port's key
    holds the same two words in int64, on the CPU (the loop's rng)."""
    return seed.cpu().to(torch.int64)


def _train_step(loss_fn, n_microbatches: int = 1,
                grad_reduce_dtype: str = "f32"):
    """``step(params, opt_state, batch, seed=None) -> (params, opt_state,
    loss)``: one step of the train loop's ``make_train_step`` (in place)
    with ``OPT_CFG``. ``loss_fn`` is the loop's: ``(params, batch) ->
    (loss, metrics)``, or with a third argument, the key read from the
    (2,) uint32 ``seed``."""
    step = make_train_step(loss_fn, OPT_CFG, TrainConfig(
        n_microbatches=max(1, n_microbatches),
        compression=_REDUCE[grad_reduce_dtype]))

    def run(params, opt_state, batch, seed=None):
        params, opt_state, _, metrics = step(
            params, opt_state, 0, batch,
            None if seed is None else _key(seed))
        return params, opt_state, metrics["loss"]
    return run


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def build_lm(cfg: LMConfig, cell: ShapeCell) -> StepSpec:
    name = f"{cfg.name}:{cell.name}"
    if cell.kind == "long" and cfg.attention == "full":
        # Paper-faithful configs are pure full attention -> skip; the
        # window variant is built via build_lm_long_window.
        return StepSpec(
            name=name, fn=None, args=(),
            skip_reason=("pure full-attention arch; long_500k requires "
                         "sub-quadratic attention (DESIGN.md). Window-"
                         "attention variant reported separately."))

    p_shapes = transformer.init(cfg, seed=0, device="meta")
    B, S = cell.global_batch, cell.seq_len

    if cell.kind == "train":
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        train_step = _train_step(
            lambda p, b: transformer.loss_fn(p, b["tokens"], b["labels"],
                                             cfg),
            cfg.train_microbatches, cfg.grad_reduce_dtype)
        return StepSpec(name=name, fn=train_step,
                        args=(p_shapes, _opt_state(p_shapes), batch),
                        donate_argnums=(0, 1))

    if cell.kind == "prefill":
        n_bc = cfg.prefill_batch_chunks or 1
        if cfg.prefill_batch_chunks == 0 and cfg.d_model >= 6144 \
                and S >= 32768:
            # the JAX package's long-prefill recipe: dp residuals, 1k
            # query chunks and batch halves keep the live set small
            cfg = dataclasses.replace(cfg, act_sharding="dp",
                                      attn_q_chunk=1024)
            n_bc = 2 if B % 2 == 0 else 1
        while B % n_bc:
            n_bc -= 1
        window = cfg.window if cfg.attention == "window" else 0

        def serve_step(params, tokens):
            impl = layers.serve_attn_impl(tokens, cfg.head_dim,
                                          window=window)
            if n_bc == 1:
                return transformer.prefill(params, tokens, cfg,
                                           attn_impl=impl)
            # the chunks run one after another: the live activations are
            # one chunk's
            bs = B // n_bc
            return torch.cat([
                transformer.prefill(params, tokens[i * bs:(i + 1) * bs],
                                    cfg, attn_impl=impl)
                for i in range(n_bc)], dim=0)

        return StepSpec(name=name, fn=serve_step,
                        args=(p_shapes, _meta((B, S), torch.int32)))

    if cell.kind in ("decode", "long"):
        c_shapes = transformer.init_cache(cfg, B, S, device="meta")

        def serve_step(params, cache, token, cache_len):
            return transformer.decode_step(params, cache, token, cache_len,
                                           cfg)

        return StepSpec(name=name, fn=serve_step,
                        args=(p_shapes, c_shapes, _meta((B, 1), torch.int32),
                              0),
                        donate_argnums=(1,))

    raise ValueError(cell.kind)


def build_lm_long_window(cfg: LMConfig, cell: ShapeCell,
                         window: int = 8192) -> StepSpec:
    """Beyond-paper variant: sliding-window attention so long_500k runs."""
    wcfg = dataclasses.replace(cfg, attention="window", window=window,
                               name=cfg.name + f"-win{window}")
    spec = build_lm(wcfg, cell)
    spec.name = f"{cfg.name}:{cell.name}:window{window}"
    return spec


# ---------------------------------------------------------------------------
# DiT family
# ---------------------------------------------------------------------------

def build_dit(cfg: DiTConfig, cell: ShapeCell) -> StepSpec:
    name = f"{cfg.name}:{cell.name}"
    p_shapes = dit.init(cfg, seed=0, device="meta")
    B = cell.global_batch
    res = cell.img_res // cfg.vae_factor
    seed = _meta((2,), torch.uint32)

    if cell.kind == "dit_train":
        batch = {"latents": _meta((B, res, res, cfg.latent_channels),
                                  torch.float32),
                 "labels": _meta((B,), torch.int32)}
        train_step = _train_step(lambda p, b, rng: dit.loss_fn(
            p, b["latents"], b["labels"], rng, cfg))
        return StepSpec(name=name, fn=train_step,
                        args=(p_shapes, _opt_state(p_shapes), batch, seed),
                        donate_argnums=(0, 1))

    if cell.kind == "dit_gen":
        def serve_step(params, labels, seed):
            return dit.sample(params, _key(seed), labels, cfg,
                              img_res=cell.img_res, n_steps=cell.steps)

        return StepSpec(name=name, fn=serve_step,
                        args=(p_shapes, _meta((B,), torch.int32), seed))

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# Vision family (ViT / DeiT / EfficientNet)
# ---------------------------------------------------------------------------

def _cls_batch(B: int, R: int) -> dict:
    return {"images": _meta((B, R, R, 3), torch.float32),
            "labels": _meta((B,), torch.int32)}


def build_vit(cfg: ViTConfig, cell: ShapeCell) -> StepSpec:
    name = f"{cfg.name}:{cell.name}"
    p_shapes = vit.init(cfg, seed=0, device="meta")
    B, R = cell.global_batch, cell.img_res

    if cell.kind == "cls":
        train_step = _train_step(lambda p, b: vit.loss_fn(
            p, b["images"], b["labels"], cfg))
        return StepSpec(name=name, fn=train_step,
                        args=(p_shapes, _opt_state(p_shapes),
                              _cls_batch(B, R)),
                        donate_argnums=(0, 1))

    if cell.kind == "serve":
        # ``serve_pure_dp`` pads the batch to a multiple of the card count
        # and spreads it over every card: on one card, the plain forward
        def serve_step(params, images):
            return vit.forward(params, images, cfg)

        return StepSpec(name=name, fn=serve_step,
                        args=(p_shapes, _meta((B, R, R, 3), torch.float32)))

    raise ValueError(cell.kind)


def build_effnet(cfg: EffNetConfig, cell: ShapeCell) -> StepSpec:
    name = f"{cfg.name}:{cell.name}"
    p_shapes, s_shapes = efficientnet.init(cfg, seed=0, device="meta")
    B, R = cell.global_batch, cell.img_res

    if cell.kind == "cls":
        def loss(p, b):
            # the batch-norm state rides in the batch and out in the
            # metrics (one micro-batch: the batch is not split)
            l, (metrics, new_state) = efficientnet.loss_fn(
                p, b["state"], b["images"], b["labels"], cfg)
            return l, dict(metrics, state=new_state)

        step = make_train_step(loss, OPT_CFG, TrainConfig())

        def train_step(params, state, opt_state, batch):
            params, opt_state, _, metrics = step(
                params, opt_state, 0, dict(batch, state=state))
            return (params, layers.tree_map(lambda t: t.detach(),
                                            metrics["state"]),
                    opt_state, metrics["loss"])

        return StepSpec(name=name, fn=train_step,
                        args=(p_shapes, s_shapes, _opt_state(p_shapes),
                              _cls_batch(B, R)),
                        donate_argnums=(0, 2))

    if cell.kind == "serve":
        def serve_step(params, state, images):
            logits, _ = efficientnet.forward(params, state, images, cfg,
                                             train=False)
            return logits

        return StepSpec(name=name, fn=serve_step,
                        args=(p_shapes, s_shapes,
                              _meta((B, R, R, 3), torch.float32)))

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def build(arch_id: str, cell_name: str, variant: Optional[str] = None,
          cfg_overrides: Optional[dict] = None) -> StepSpec:
    cfg = get_arch(arch_id)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = get_shapes(arch_id)[cell_name]
    if isinstance(cfg, LMConfig):
        if cell.kind == "long" and variant == "window":
            return build_lm_long_window(cfg, cell)
        return build_lm(cfg, cell)
    if isinstance(cfg, DiTConfig):
        return build_dit(cfg, cell)
    if isinstance(cfg, ViTConfig):
        return build_vit(cfg, cell)
    if isinstance(cfg, EffNetConfig):
        return build_effnet(cfg, cell)
    raise TypeError(type(cfg))
