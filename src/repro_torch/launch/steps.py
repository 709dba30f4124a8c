"""Step builders: (arch, shape cell, mesh) -> a step function, its
abstract inputs and, on a mesh, their shardings, for the trainer and the
server. A port of ``repro.launch.steps``.

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

``donate_argnums`` names the arguments the step updates in place: a
train step's parameters and optimizer state, a decode step's cache
(C10). ``build(..., mesh=m)`` adds ``in_shardings``/``out_shardings``:
trees of specs (``distributed.sharding.P``) in the args' layout, leaf
for leaf the JAX builder's ``NamedSharding``s (FSDP + TP parameters,
AdamW moments as their parameters, or ZeRO-1 under ``ddp_zero1``, the
batch over the largest data axes that divide it, the KV cache by
``_cache_sharding``). On an ``AbstractMesh``
(``launch.mesh.make_abstract_mesh``) the spec only carries them; on a
``DeviceMesh`` ``spec.fn`` takes its arguments plain or as DTensors,
lays them out by ``in_shardings``, runs the step with the models'
``mesh=`` constraints, and returns DTensors on ``out_shardings``. A
train step updates DTensor arguments in place; plain ones are copied
onto the mesh first, so use what it returns:

  mesh = launch.mesh.make_mesh((1, 1), ("data", "model"))
  spec = build("olmo-1b", "train_4k", mesh=mesh)
  state = distribute((params, opt_state, batch), spec.in_shardings, mesh)
  params, opt_state, loss = spec.fn(*state)

The steps compute what the JAX package's do:

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
  cell's steps, the (2,) uint32 seed, passed on the host, read as a
  ``common.prng`` key;
- ViT/DeiT and EfficientNet: training and serving (EfficientNet's train
  step returns the new batch-norm state; serving runs ``train=False``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.common.config import (DiTConfig, EffNetConfig, LMConfig,
                                       ShapeCell, ViTConfig)
from repro_torch.configs import get_arch, get_shapes
from repro_torch.distributed.sharding import (P, distribute, is_device_mesh,
                                              is_dtensor, mesh_shape,
                                              param_shardings, tree_paths)
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
    in_shardings: Any = None       # trees of specs, with a mesh
    out_shardings: Any = None


def _dp_axes(mesh, batch: int):
    """The largest (pod, data) combination that divides the batch, else
    None."""
    shape = mesh_shape(mesh)
    names = [n for n in ("pod", "data") if n in shape]
    cands = []
    if len(names) == 2:
        cands.append(tuple(names))
    cands += [(n,) for n in names]
    for c in sorted(cands, key=lambda c: -math.prod(shape[n] for n in c)):
        if batch % math.prod(shape[n] for n in c) == 0:
            return c if len(c) > 1 else c[0]
    return None


def _all_axes(mesh) -> tuple:
    return tuple(mesh_shape(mesh))


def _replicated(tree):
    """``P()`` for every leaf of a tree."""
    return layers.tree_map(lambda _: P(), tree)


def _cache_sharding(cfg: LMConfig, cell: ShapeCell, mesh) -> P:
    """(L, B, S, KV, hd) cache: batch over dp; the model axis over KV heads
    when they divide, else over the sequence (SP: MQA/GQA with few heads,
    long caches); a long cell (B = 1) spends every axis on the sequence."""
    shape = mesh_shape(mesh)
    dp = _dp_axes(mesh, cell.global_batch)
    m = shape["model"]
    if cell.kind == "long":
        axes = _all_axes(mesh)
        if cell.seq_len % math.prod(shape[a] for a in axes) == 0:
            return P(None, None, axes, None, None)
    if cfg.n_kv_heads % m == 0:
        return P(None, dp, None, "model", None)
    if cell.seq_len % m == 0:
        return P(None, dp, "model", None, None)
    return P(None, dp, None, None, None)


def _zero1_shardings(o_shapes, mesh):
    """AdamW's moments over as much of the mesh as divides their leading
    dim (ZeRO-1); scalars (and the step count) replicated."""
    shape = mesh_shape(mesh)
    axes = _all_axes(mesh)

    def visit(leaf):
        ndim = leaf.dim() if isinstance(leaf, torch.Tensor) else 0
        for cand in (axes, axes[:-1], axes[-1:]):
            size = math.prod(shape[a] for a in cand) if cand else 1
            if ndim >= 1 and leaf.shape[0] % size == 0 and size > 1:
                return P(cand if len(cand) > 1 else cand[0],
                         *([None] * (ndim - 1)))
        return P()

    return layers.tree_map(visit, o_shapes)


def _opt_shardings(p_shard):
    """AdamW's state laid out as its parameters: ``m`` and ``v`` leaf for
    leaf the parameter specs in ``param_leaves`` order (JAX's
    ``param_shardings`` of the state finds the same rules under ``m/``
    and ``v/``), ``step`` replicated."""
    specs = [s for _, s in tree_paths(p_shard)]
    return {"m": specs, "v": list(specs), "step": P()}


def _spec(mesh, name, fn, args, in_sh, out_sh, donate=(), on_host=()):
    """A ``StepSpec``. With a mesh it carries the shardings, and on a
    ``DeviceMesh`` its ``fn`` lays the arguments out by ``in_sh`` first
    and the results by ``out_sh`` after; on an abstract mesh ``fn`` is
    the step itself. The arguments numbered in ``on_host`` (the seed,
    which the loop's rng reads on the host) stay where the caller put
    them: their spec is replicated, and every rank passes the same
    values."""
    if mesh is None:
        return StepSpec(name=name, fn=fn, args=args, donate_argnums=donate)
    run = fn
    if fn is not None and is_device_mesh(mesh):
        def run(*a):
            a = tuple(x if i in on_host else distribute(x, s, mesh)
                      for i, (x, s) in enumerate(zip(a, in_sh)))
            return distribute(fn(*a), out_sh, mesh)
    return StepSpec(name=name, fn=run, args=args, donate_argnums=donate,
                    in_shardings=in_sh, out_shardings=out_sh)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _opt_state(p_shapes):
    return opt.init(param_leaves(p_shapes))


def _key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.wrap_key_data`` of a (2,) uint32 seed on the host: the
    port's key holds the same two words in int64, on the CPU (the loop's
    rng; ROADMAP's standing divergences), so the step reads nothing from
    the card. A replicated DTensor seed (a traced step's layout) is read
    from its local copy. A meta seed (a traced step, ``launch.dryrun``)
    gives a meta key: ``common.prng`` draws shapes from it and reads no
    bits."""
    if is_dtensor(seed):
        seed = seed.to_local()
    if seed.device.type not in ("cpu", "meta"):
        raise ValueError(f"the step's seed lives on the host with the "
                         f"loop's rng, got one on {seed.device}")
    return seed.to(torch.int64)


def _train_step(loss_fn, n_microbatches: int = 1,
                grad_reduce_dtype: str = "f32", mesh=None):
    """``step(params, opt_state, batch, seed=None) -> (params, opt_state,
    loss)``: one step of the train loop's ``make_train_step`` (in place)
    with ``OPT_CFG``. ``loss_fn`` is the loop's: ``(params, batch) ->
    (loss, metrics)``, or with a third argument, the key read from the
    (2,) uint32 ``seed``."""
    step = make_train_step(loss_fn, OPT_CFG, TrainConfig(
        n_microbatches=max(1, n_microbatches),
        compression=_REDUCE[grad_reduce_dtype]), mesh=mesh)

    def run(params, opt_state, batch, seed=None):
        params, opt_state, _, metrics = step(
            params, opt_state, 0, batch,
            None if seed is None else _key(seed))
        return params, opt_state, metrics["loss"]
    return run


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def build_lm(cfg: LMConfig, cell: ShapeCell, mesh=None) -> StepSpec:
    name = f"{cfg.name}:{cell.name}"
    if cell.kind == "long" and cfg.attention == "full":
        # Paper-faithful configs are pure full attention -> skip; the
        # window variant is built via build_lm_long_window.
        return StepSpec(
            name=name, fn=None, args=(),
            skip_reason=("pure full-attention arch; long_500k requires "
                         "sub-quadratic attention (DESIGN.md). Window-"
                         "attention variant reported separately."),
            in_shardings=None if mesh is None else (),
            out_shardings=None)

    p_shapes = transformer.init(cfg, seed=0, device="meta")
    B, S = cell.global_batch, cell.seq_len
    ddp = cfg.parallelism == "ddp_zero1"
    p_shard = dp = None
    if mesh is not None:
        # ZeRO-1 (ddp_zero1): parameters replicated, only the optimizer
        # moments sharded, the batch over every mesh axis that divides it
        p_shard = (_replicated(p_shapes) if ddp
                   else param_shardings(p_shapes, mesh, scan_layers=True))
        dp = _dp_axes(mesh, B)
        if ddp:
            shape = mesh_shape(mesh)
            all_ax = _all_axes(mesh)
            if B % math.prod(shape[a] for a in all_ax) == 0:
                dp = all_ax
    model_mesh = None if ddp else mesh   # no activation constraints in DDP
    vocab_ax = None if ddp else "model"

    if cell.kind == "train":
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        o_shapes = _opt_state(p_shapes)
        train_step = _train_step(
            lambda p, b: transformer.loss_fn(p, b["tokens"], b["labels"],
                                             cfg, mesh=model_mesh),
            cfg.train_microbatches, cfg.grad_reduce_dtype, mesh=mesh)
        in_sh = out_sh = None
        if mesh is not None:
            o_shard = (_zero1_shardings(o_shapes, mesh) if ddp
                       else _opt_shardings(p_shard))
            b_shard = {"tokens": P(dp, None), "labels": P(dp, None)}
            in_sh = (p_shard, o_shard, b_shard)
            out_sh = (p_shard, o_shard, P())
        return _spec(mesh, name, train_step, (p_shapes, o_shapes, batch),
                     in_sh, out_sh, donate=(0, 1))

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
                                           attn_impl=impl, mesh=model_mesh)
            # the chunks run one after another: the live activations are
            # one chunk's
            bs = B // n_bc
            return torch.cat([
                transformer.prefill(params, tokens[i * bs:(i + 1) * bs],
                                    cfg, attn_impl=impl, mesh=model_mesh)
                for i in range(n_bc)], dim=0)

        in_sh = out_sh = None
        if mesh is not None:
            in_sh = (p_shard, P(dp, None))
            out_sh = P(dp, None, vocab_ax)
        return _spec(mesh, name, serve_step,
                     (p_shapes, _meta((B, S), torch.int32)), in_sh, out_sh)

    if cell.kind in ("decode", "long"):
        c_shapes = transformer.init_cache(cfg, B, S, device="meta")

        def serve_step(params, cache, token, cache_len):
            return transformer.decode_step(params, cache, token, cache_len,
                                           cfg, mesh=model_mesh)

        in_sh = out_sh = None
        if mesh is not None:
            c = _cache_sharding(cfg, cell, mesh)
            c_shard = {"k": c, "v": c}
            in_sh = (p_shard, c_shard, P(dp, None), P())
            out_sh = (P(dp, None, vocab_ax), c_shard)
        return _spec(mesh, name, serve_step,
                     (p_shapes, c_shapes, _meta((B, 1), torch.int32), 0),
                     in_sh, out_sh, donate=(1,))

    raise ValueError(cell.kind)


def build_lm_long_window(cfg: LMConfig, cell: ShapeCell, mesh=None,
                         window: int = 8192) -> StepSpec:
    """Beyond-paper variant: sliding-window attention so long_500k runs."""
    wcfg = dataclasses.replace(cfg, attention="window", window=window,
                               name=cfg.name + f"-win{window}")
    spec = build_lm(wcfg, cell, mesh)
    spec.name = f"{cfg.name}:{cell.name}:window{window}"
    return spec


# ---------------------------------------------------------------------------
# DiT family
# ---------------------------------------------------------------------------

def build_dit(cfg: DiTConfig, cell: ShapeCell, mesh=None) -> StepSpec:
    name = f"{cfg.name}:{cell.name}"
    p_shapes = dit.init(cfg, seed=0, device="meta")
    B = cell.global_batch
    res = cell.img_res // cfg.vae_factor
    seed = _meta((2,), torch.uint32)
    p_shard = dp = None
    if mesh is not None:
        p_shard = param_shardings(p_shapes, mesh, scan_layers=True)
        dp = _dp_axes(mesh, B)

    if cell.kind == "dit_train":
        batch = {"latents": _meta((B, res, res, cfg.latent_channels),
                                  torch.float32),
                 "labels": _meta((B,), torch.int32)}
        train_step = _train_step(lambda p, b, rng: dit.loss_fn(
            p, b["latents"], b["labels"], rng, cfg, mesh=mesh), mesh=mesh)
        in_sh = out_sh = None
        if mesh is not None:
            o_shard = _opt_shardings(p_shard)
            in_sh = (p_shard, o_shard,
                     {"latents": P(dp, None, None, None), "labels": P(dp)},
                     P(None))
            out_sh = (p_shard, o_shard, P())
        return _spec(mesh, name, train_step,
                     (p_shapes, _opt_state(p_shapes), batch, seed),
                     in_sh, out_sh, donate=(0, 1), on_host=(3,))

    if cell.kind == "dit_gen":
        def serve_step(params, labels, seed):
            return dit.sample(params, _key(seed), labels, cfg,
                              img_res=cell.img_res, n_steps=cell.steps,
                              mesh=mesh)

        in_sh = out_sh = None
        if mesh is not None:
            in_sh = (p_shard, P(dp), P(None))
            out_sh = P(dp, None, None, None)
        return _spec(mesh, name, serve_step,
                     (p_shapes, _meta((B,), torch.int32), seed),
                     in_sh, out_sh, on_host=(2,))

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# Vision family (ViT / DeiT / EfficientNet)
# ---------------------------------------------------------------------------

def _cls_batch(B: int, R: int) -> dict:
    return {"images": _meta((B, R, R, 3), torch.float32),
            "labels": _meta((B,), torch.int32)}


def build_vit(cfg: ViTConfig, cell: ShapeCell, mesh=None) -> StepSpec:
    name = f"{cfg.name}:{cell.name}"
    p_shapes = vit.init(cfg, seed=0, device="meta")
    B, R = cell.global_batch, cell.img_res
    p_shard = dp = img = None
    if mesh is not None:
        p_shard = param_shardings(p_shapes, mesh, scan_layers=True)
        dp = _dp_axes(mesh, B)
        img = P(dp, None, None, None)

    if cell.kind == "cls":
        train_step = _train_step(lambda p, b: vit.loss_fn(
            p, b["images"], b["labels"], cfg, mesh=mesh), mesh=mesh)
        in_sh = out_sh = None
        if mesh is not None:
            o_shard = _opt_shardings(p_shard)
            in_sh = (p_shard, o_shard, {"images": img, "labels": P(dp)})
            out_sh = (p_shard, o_shard, P())
        return _spec(mesh, name, train_step,
                     (p_shapes, _opt_state(p_shapes), _cls_batch(B, R)),
                     in_sh, out_sh, donate=(0, 1))

    if cell.kind == "serve":
        images = _meta((B, R, R, 3), torch.float32)
        if cfg.serve_pure_dp and mesh is not None:
            # Pure-DP serving: weights replicated, the batch padded to a
            # multiple of the device count and spread over every axis
            n_dev = math.prod(mesh_shape(mesh).values())
            pad_to = -(-B // n_dev) * n_dev
            spread = P(_all_axes(mesh), None, None, None)

            def serve_step(params, images):
                x = torch.nn.functional.pad(
                    images, (0, 0, 0, 0, 0, 0, 0, pad_to - B))
                if is_device_mesh(mesh):
                    x = distribute(x, spread, mesh)
                return vit.forward(params, x, cfg)[:B]

            return _spec(mesh, name, serve_step, (p_shapes, images),
                         (_replicated(p_shapes), img), P(dp, None))

        # on one card (no mesh) ``serve_pure_dp`` pads to a multiple of
        # one card: the plain forward
        def serve_step(params, images):
            return vit.forward(params, images, cfg, mesh=mesh)

        return _spec(mesh, name, serve_step, (p_shapes, images),
                     None if mesh is None else (p_shard, img),
                     None if mesh is None else P(dp, None))

    raise ValueError(cell.kind)


def build_effnet(cfg: EffNetConfig, cell: ShapeCell, mesh=None) -> StepSpec:
    name = f"{cfg.name}:{cell.name}"
    p_shapes, s_shapes = efficientnet.init(cfg, seed=0, device="meta")
    B, R = cell.global_batch, cell.img_res
    p_shard = s_shard = dp = img = None
    if mesh is not None:
        p_shard = param_shardings(p_shapes, mesh, scan_layers=False)
        s_shard = param_shardings(s_shapes, mesh, scan_layers=False)
        dp = _dp_axes(mesh, B)
        img = P(dp, None, None, None)

    if cell.kind == "cls":
        def loss(p, b):
            # the batch-norm state rides in the batch and out in the
            # metrics (one micro-batch: the batch is not split)
            l, (metrics, new_state) = efficientnet.loss_fn(
                p, b["state"], b["images"], b["labels"], cfg, mesh=mesh)
            return l, dict(metrics, state=new_state)

        step = make_train_step(loss, OPT_CFG, TrainConfig(), mesh=mesh)

        def train_step(params, state, opt_state, batch):
            params, opt_state, _, metrics = step(
                params, opt_state, 0, dict(batch, state=state))
            return (params, layers.tree_map(lambda t: t.detach(),
                                            metrics["state"]),
                    opt_state, metrics["loss"])

        in_sh = out_sh = None
        if mesh is not None:
            o_shard = _opt_shardings(p_shard)
            in_sh = (p_shard, s_shard, o_shard,
                     {"images": img, "labels": P(dp)})
            out_sh = (p_shard, s_shard, o_shard, P())
        return _spec(mesh, name, train_step,
                     (p_shapes, s_shapes, _opt_state(p_shapes),
                      _cls_batch(B, R)),
                     in_sh, out_sh, donate=(0, 2))

    if cell.kind == "serve":
        def serve_step(params, state, images):
            logits, _ = efficientnet.forward(params, state, images, cfg,
                                             train=False, mesh=mesh)
            return logits

        return _spec(mesh, name, serve_step,
                     (p_shapes, s_shapes,
                      _meta((B, R, R, 3), torch.float32)),
                     None if mesh is None else (p_shard, s_shard, img),
                     None if mesh is None else P(dp, None))

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def build(arch_id: str, cell_name: str, variant: Optional[str] = None,
          cfg_overrides: Optional[dict] = None, *, mesh=None) -> StepSpec:
    """The step of (arch, cell): ``mesh`` None (one card, no shardings),
    an ``AbstractMesh`` (shardings only) or a ``DeviceMesh`` (shardings,
    and ``fn`` runs on it)."""
    cfg = get_arch(arch_id)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = get_shapes(arch_id)[cell_name]
    if isinstance(cfg, LMConfig):
        if cell.kind == "long" and variant == "window":
            return build_lm_long_window(cfg, cell, mesh)
        return build_lm(cfg, cell, mesh)
    if isinstance(cfg, DiTConfig):
        return build_dit(cfg, cell, mesh)
    if isinstance(cfg, ViTConfig):
        return build_vit(cfg, cell, mesh)
    if isinstance(cfg, EffNetConfig):
        return build_effnet(cfg, cell, mesh)
    raise TypeError(type(cfg))
