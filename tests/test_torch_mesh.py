"""The port's multi-card layer on several ranks: 4 gloo processes on the
CPU form a (2, 2) ``("data", "model")`` ``DeviceMesh`` (``launch.mesh``),
and what they compute is held against the unsharded port and the JAX
package.

One module-scoped run starts the 4 ranks (this file run as a script, on
a ``FileStore`` under the test's temporary directory, one thread each);
each rank writes its results to an npz file, and the parent computes
the references meanwhile and asserts. One JAX subprocess with 4 forced
host devices gives what needs more than one JAX device: the blocks
``NamedSharding.devices_indices_map`` assigns each device, and
``choose_mesh``'s shapes.

- Each rank's local block of every leaf of reduced olmo-1b and moonshot
  is the slice the JAX spec gives its mesh coordinate (exact).
- Reduced olmo-1b's built ``train_4k`` step (batch 4 x 16 tokens,
  ``train_microbatches`` 2), 2 steps, ``grad_reduce_dtype`` f32 and bf16:
  the loss line within 1e-5 relative of the unsharded port step's and of
  JAX's built step's; AdamW's ``m`` and ``v`` within 1e-5 of each leaf's
  largest |value|, and each parameter's change within 1e-5 of its leaf's
  largest |change| or one fp32 ulp of the new value (a change is the
  difference of two values ~1e5 times larger: one ulp of rounding in the
  new value is far more than 1e-5 of the change, as
  ``tests/test_torch_steps.py`` holds it). In bf16 an element of ``m``
  or ``v`` may also be off by one bf16 ulp of the gradient (2**-7 of it
  in ``m``, 2**-6 in ``v``): the sharded and unsharded fp32 gradients
  sum in other orders (~1e-7 relative), and a value that close to a
  bf16 rounding midpoint rounds to either side.
- The same train step (f32, d_model 256 in 4 heads of 64, one step) on
  a (1, 4) mesh of the same 4 ranks, one head on each model rank:
  within 1e-5 of the unsharded port step and of JAX's (ROADMAP C19).
- Reduced moonshot's forward on the mesh, on tokens whose router top-k
  margin is at least 1e-4 in every layer (ROADMAP C14): every layer's
  choices equal the unsharded model's, and the logits are within 1e-5
  of the largest |logit| of the unsharded model's and of JAX's.
- Reduced moonshot's built ``train_4k`` step (fp32, 4 micro-batches of
  2 x 32 tokens, one step) on such tokens, its experts' weights
  gathered over "data" before their products (ROADMAP C26): within
  1e-5 of the unsharded port step by ``_same_step``'s rule; and
  ``sharding.data_gathered`` runs one all-gather forward and one
  reduce-scatter backward, the gradient on the weight's placements.
- Built serve steps of the other families, reduced, on the mesh against
  the unsharded step, within 1e-5 of the largest |value|: olmo-1b's
  decode on each cache layout ``_cache_sharding`` gives (KV heads over
  "model"; one KV head, so the sequence over "model"; the long cell's
  window variant at batch 1, the sequence over both axes), its sharded
  KV cache written in place; dit-s2's sampler (2 steps) and
  efficientnet-b7's serve step.
- Reduced efficientnet-b7's built ``cls_224`` train step (batch 4), one
  step on the mesh: loss and batch-norm state within 1e-5 of the
  unsharded step's, AdamW's moments (the gradients) within
  ``chip_smoke.py``'s EfficientNet gradient bound (ROADMAP C25).
- A reduced ViT's built ``cls_224`` train step (batch 4 at 32 px), one
  step on the mesh: loss, moments and changes as above, against the
  unsharded step and JAX's built step.
- ``compressed_psum`` over ``"data"`` and over ``"model"`` is bitwise
  JAX's ``compressed_psum`` under ``jax.vmap(..., axis_name=)`` on the
  same per-rank inputs.
- ``choose_mesh`` shapes equal JAX's for n in 1..4 ranks, model
  parallelism 1, 2, 4 and 1 or 2 pods (where JAX's mesh is empty, the
  port raises).
- ``reshard`` onto a 2-rank mesh keeps every value exactly, with the
  new mesh's placements; a sharded save writes the bytes of an
  unsharded save of the same values, and its restore onto the mesh with
  ``param_shardings`` gives them back exactly, placed by their specs.
- ``train_loop.train(..., mesh=)`` with int8 error feedback, sharded
  checkpoints every step and a resumed run, against the unsharded loop;
  ``apply_ef`` on a DTensor bitwise the unsharded call.
- ``sharding.CONSTRAIN_MISSES`` stays 0 on every rank.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 4
SHAPE = (2, 2)
AXES = ("data", "model")
ARCHS = ("olmo-1b", "moonshot-v1-16b-a3b")
TRAIN_B, TRAIN_S = 4, 16
# reduced moonshot's train step: its 4 micro-batches of 2 x 32 tokens
# make 2 groups of 32 each, one on each data rank
MOE_TRAIN_B, MOE_TRAIN_S = 8, 32
VIT_B = 4
MARGIN = 1e-4
CHOOSE = [(n, mp, pods) for n in range(1, 5) for mp in (1, 2, 4)
          for pods in (1, 2)]
ATOL = 1e-5
# one query head a rank on a (1, 4) mesh, at head_dim 64 (ROADMAP C19)
HEAD_A_RANK = {"d_model": 256, "n_heads": 4, "n_kv_heads": 4}
# decode cases: (name, config changes, cell, window, batch, cache slots,
# tokens) and the cache spec _cache_sharding gives each on the (2, 2)
# mesh: KV heads over "model"; one KV head, so the sequence over "model"
# (SP); the long cell's window variant at batch 1, the sequence over
# every axis. The SP caches hold one slot a rank, so that the tokens'
# slots lie on more than one rank's block.
DECODES = (("decode", {}, "decode_32k", 0, TRAIN_B, 16, 3),
           ("decode_sp", {"n_kv_heads": 1}, "decode_32k", 0, TRAIN_B, 2, 2),
           ("decode_long", {}, "long_500k", 2, 1, 4, 3))
CACHE_SPECS = {"decode": "P(None, 'data', None, 'model', None)",
               "decode_sp": "P(None, 'data', 'model', None, None)",
               "decode_long": "P(None, None, ('data', 'model'), None, None)"}


# ---------------------------------------------------------------------------
# What the ranks run (this file as a script); no JAX here
# ---------------------------------------------------------------------------

def _cfg(arch, **over):
    from repro_torch.common.config import reduced
    from repro_torch.configs import get_arch
    return reduced(get_arch(arch), dtype="float32", **over)


def _lm_batch(cfg, seed=0):
    g = np.random.default_rng(seed)
    return {k: torch.from_numpy(g.integers(0, cfg.vocab_size,
                                           (TRAIN_B, TRAIN_S), np.int32))
            for k in ("tokens", "labels")}


def _vit_batch(cfg, seed=0):
    g = np.random.default_rng(seed)
    return {"images": torch.from_numpy(g.standard_normal(
                (VIT_B, cfg.img_res, cfg.img_res, 3)).astype(np.float32)),
            "labels": torch.from_numpy(g.integers(0, cfg.n_classes, (VIT_B,),
                                                  np.int32))}


def _lm_train_spec(grad_dtype, mesh=None, **over):
    """(cfg, cell, the built step) of reduced olmo-1b's train_4k (``over``
    changes the config)."""
    from repro_torch.configs import get_shapes
    from repro_torch.launch import steps as ST
    cfg = _cfg("olmo-1b", train_microbatches=2, grad_reduce_dtype=grad_dtype,
               **over)
    cell = dataclasses.replace(get_shapes("olmo-1b")["train_4k"],
                               global_batch=TRAIN_B, seq_len=TRAIN_S)
    return cfg, cell, ST.build_lm(cfg, cell, mesh)


def _moe_train_spec(mesh=None):
    """(cfg, cell, the built step) of reduced moonshot's train_4k at
    ``MOE_TRAIN_B`` x ``MOE_TRAIN_S``."""
    from repro_torch.configs import get_shapes
    from repro_torch.launch import steps as ST
    cfg = _cfg("moonshot-v1-16b-a3b")
    cell = dataclasses.replace(get_shapes("moonshot-v1-16b-a3b")["train_4k"],
                               global_batch=MOE_TRAIN_B, seq_len=MOE_TRAIN_S)
    return cfg, cell, ST.build_lm(cfg, cell, mesh)


def _moe_batch(cfg, p):
    """Tokens routed with a top-k margin of ``MARGIN`` (``moe_tokens``)
    and seeded labels."""
    return {"tokens": moe_tokens(cfg, p, MOE_TRAIN_B, MOE_TRAIN_S)[0],
            "labels": torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab_size, (MOE_TRAIN_B, MOE_TRAIN_S), np.int32))}


def _vit_train_spec(mesh=None):
    """(cfg, cell, the built step) of reduced vit-s16's cls_224."""
    from repro_torch.configs import get_shapes
    from repro_torch.launch import steps as ST
    cfg = _cfg("vit-s16")
    cell = dataclasses.replace(get_shapes("vit-s16")["cls_224"],
                               global_batch=VIT_B, img_res=cfg.img_res)
    return cfg, cell, ST.build_vit(cfg, cell, mesh)


def effnet_train(mesh):
    """Reduced efficientnet-b7's built cls_224 train step (fp32, batch
    ``VIT_B``), one step on ``mesh`` and unsharded from the same weights,
    state and images: the batch norm's statistics of a sharded batch
    (ROADMAP C25). npz entries ``effnet_train/{mesh,unsharded}/<part>/<i>``
    for the loss, every leaf of the new batch-norm state, and AdamW's
    moments (the step's gradients, m = (1 - b1) g, v = (1 - b2) g^2)."""
    from repro_torch.configs import get_shapes
    from repro_torch.distributed.sharding import full_tensor, tree_paths
    from repro_torch.launch import steps as ST
    from repro_torch.models import efficientnet as E
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import param_leaves
    cfg = _cfg("efficientnet-b7")
    cell = dataclasses.replace(get_shapes("efficientnet-b7")["cls_224"],
                               global_batch=VIT_B, img_res=cfg.img_res)
    batch = _vit_batch(cfg)
    flat = {}
    for m in (mesh, None):
        params, state = E.init(cfg, 0, "cpu")
        spec = ST.build_effnet(cfg, cell, m)
        params, state, o, loss = spec.fn(
            params, state, opt.init(param_leaves(params)), batch)
        parts = {"loss": [loss], "state": state, "m": o["m"],
                 "v": o["v"]}
        for part, tree in parts.items():
            outs = full_tensor([t for _, t in tree_paths(tree)])
            for i, t in enumerate(outs):
                flat[f"effnet_train/{'mesh' if m else 'unsharded'}/{part}/"
                     f"{i}"] = t.double().numpy()
    return flat


def run_train(spec, params, batch, n_steps=2):
    """``n_steps`` of a built train step from ``params``: {"loss": the
    loss line, "m"/"v": each step's moments, "change": each parameter's
    change over the steps, "after": the new parameters}, float64 numpy."""
    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import param_leaves
    f64 = lambda ts: [t.double().numpy() for t in full_tensor(ts)]
    before = f64(param_leaves(params))
    state = opt.init(param_leaves(params))
    out = {"loss": [], "m": [], "v": []}
    for _ in range(n_steps):
        params, state, loss = spec.fn(params, state, batch)
        out["loss"].append(float(full_tensor(loss)))
        out["m"].append(f64(state["m"]))
        out["v"].append(f64(state["v"]))
    out["after"] = f64(param_leaves(params))
    out["change"] = [a - b for a, b in zip(out["after"], before)]
    return out


def _flat(out, prefix):
    """A ``run_train`` result as npz entries."""
    flat = {f"{prefix}/loss": np.array(out["loss"])}
    for i, c in enumerate(out["change"]):
        flat[f"{prefix}/change/{i}"] = c
    for s, (m, v) in enumerate(zip(out["m"], out["v"])):
        for i, (a, b) in enumerate(zip(m, v)):
            flat[f"{prefix}/m/{s}/{i}"], flat[f"{prefix}/v/{s}/{i}"] = a, b
    return flat


def _unflat(z, prefix, n_steps=2):
    n = len([k for k in z if k.startswith(f"{prefix}/change/")])
    return {"loss": z[f"{prefix}/loss"],
            "change": [z[f"{prefix}/change/{i}"] for i in range(n)],
            "m": [[z[f"{prefix}/m/{s}/{i}"] for i in range(n)]
                  for s in range(n_steps)],
            "v": [[z[f"{prefix}/v/{s}/{i}"] for i in range(n)]
                  for s in range(n_steps)]}


def _routes(fn):
    """(fn's result, every ``moe_route`` call's chosen experts (full),
    every call's router probabilities)."""
    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.models import layers as L
    idxs, probs, real = [], [], L.moe_route

    def spy(*a, **k):
        out = real(*a, **k)
        probs.append(full_tensor(out[0]).detach())
        idxs.append(full_tensor(out[1]).numpy())
        return out
    L.moe_route = spy
    try:
        res = fn()
    finally:
        L.moe_route = real
    return res, idxs, probs


def run_loop(mesh, ckpt_dir):
    """``train_loop.train`` on reduced olmo-1b (``mesh``'s DTensors, or
    plain tensors without one) with int8 error feedback, every step
    logged and checkpointed: 2 steps, then a second call from fresh
    weights that resumes from the checkpoint and runs a third. Returns
    (the logged losses, the final parameters, float64 numpy)."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.steps import OPT_CFG
    from repro_torch.models import transformer as T
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_loop import TrainConfig, param_leaves, train
    cfg = _cfg("olmo-1b")

    def loss(p, b):
        return T.loss_fn(p, b["tokens"], b["labels"], cfg, mesh=mesh)

    def data():
        for i in range(8):
            yield _lm_batch(cfg, seed=10 + i)

    def params():
        p = T.init(cfg, 0, "cpu")
        return p if mesh is None else S.distribute(
            p, S.param_shardings(p, mesh), mesh)

    ckpt = CheckpointManager(ckpt_dir, async_save=False)
    losses = []
    for steps in (2, 3):
        p, hist = train(loss, params(), data(), OPT_CFG,
                        TrainConfig(steps=steps, log_every=1, ckpt_every=1,
                                    compression="int8_ef"),
                        ckpt=ckpt, mesh=mesh)
        losses += [h["loss"] for h in hist]
    return (np.array(losses),
            [t.double().numpy() for t in S.full_tensor(param_leaves(p))])


def _flat_loop(res):
    flat = {"loop/loss": res[0]}
    flat.update({f"loop/param/{i}": a for i, a in enumerate(res[1])})
    return flat


def serve_steps(mesh):
    """Built serve steps of the other families, each on ``mesh`` and
    unsharded from the same weights and inputs: olmo-1b's ``DECODES``
    (caches made on the mesh by ``init_cache`` with the step's
    cache spec: the logits at each token and the caches),
    dit-s2's gen_fast (batch 4, 2 sampler steps) and efficientnet-b7's
    serve_b1 (batch 4), reduced fp32 configs; npz entries
    ``serve/<name>/{mesh,unsharded}/<i>``."""
    from repro_torch.configs import get_shapes
    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.launch import steps as ST
    from repro_torch.models import dit as D
    from repro_torch.models import efficientnet as E
    from repro_torch.models import transformer as T
    flat = {}

    def put(name, outs):
        for i, t in enumerate(full_tensor(list(outs))):
            flat[f"serve/{name}/{i}"] = t.double().numpy()

    for name, cfg, cell, window, B, slots, n_tok in DECODES:
        cfg = _cfg("olmo-1b", **cfg)
        cell = dataclasses.replace(get_shapes("olmo-1b")[cell],
                                   global_batch=B, seq_len=slots)
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (B, n_tok), np.int32))
        for m in (mesh, None):
            spec = (ST.build_lm_long_window(cfg, cell, m, window=window)
                    if window else ST.build_lm(cfg, cell, m))
            p = T.init(cfg, 0, "cpu")
            cache = T.init_cache(cfg, B, slots, device="cpu", mesh=m,
                                 spec=m and spec.in_shardings[1]["k"])
            if m is not None:
                flat[f"serve/{name}/spec"] = np.array(
                    repr(spec.in_shardings[1]["k"]))
            outs = []
            for t in range(n_tok):
                logits, cache = spec.fn(p, cache, toks[:, t:t + 1], t)
                outs.append(logits)
            put(f"{name}/{'mesh' if m else 'unsharded'}",
                outs + [cache["k"], cache["v"]])

    cfg = _cfg("dit-s2")
    cell = dataclasses.replace(get_shapes("dit-s2")["gen_fast"],
                               global_batch=TRAIN_B, img_res=cfg.img_res,
                               steps=2)
    labels = torch.arange(TRAIN_B, dtype=torch.int32)
    seed = torch.tensor([0, 7], dtype=torch.uint32)
    for m in (mesh, None):
        spec = ST.build_dit(cfg, cell, m)
        put(f"dit/{'mesh' if m else 'unsharded'}",
            [spec.fn(D.init(cfg, 0, "cpu"), labels, seed)])

    cfg = _cfg("efficientnet-b7")
    cell = dataclasses.replace(get_shapes("efficientnet-b7")["serve_b1"],
                               global_batch=TRAIN_B, img_res=cfg.img_res)
    images = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (TRAIN_B, cfg.img_res, cfg.img_res, 3)).astype(np.float32))
    for m in (mesh, None):
        spec = ST.build_effnet(cfg, cell, m)
        put(f"effnet/{'mesh' if m else 'unsharded'}",
            [spec.fn(*E.init(cfg, 0, "cpu"), images)])
    return flat


def _margin(probs, k):
    srt = torch.sort(probs, dim=-1, descending=True).values[..., :k + 1]
    return float((srt[..., :-1] - srt[..., 1:]).min())


def moe_tokens(cfg, p, B=TRAIN_B, S=TRAIN_S):
    """The first seed's (B, S) tokens whose router top-k margin is at
    least ``MARGIN`` in every layer of the unsharded model: (tokens, its
    logits, each layer's chosen experts)."""
    from repro_torch.models import transformer as T
    for seed in range(50):
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (B, S), np.int32))
        (ref, _), ridx, rprobs = _routes(lambda: T.forward(p, toks, cfg))
        if min(_margin(pr, cfg.moe_top_k) for pr in rprobs) >= MARGIN:
            return toks, ref, ridx
    raise AssertionError(f"no tokens with a top-k margin of {MARGIN}")


def gather_collectives(mesh):
    """``sharding.data_gathered`` of an expert weight laid out as
    ``moe/wi`` ("model", "data", None), a product with an input laid out
    as "experts" (experts over "model", groups over "data") and its
    backward: npz entries with the c10d collectives each pass ran, the
    gradient's placements against the weight's, and whether the
    gradient equals the unsharded one."""
    from torch.distributed.tensor import distribute_tensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.distributed import sharding as S

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if func.namespace == "_c10d_functional" and not (
                    name == "wait_tensor" or name.startswith("_")):
                self.ops.append(name)
            return func(*args, **(kwargs or {}))

    g = np.random.default_rng(8)
    w = torch.from_numpy(g.standard_normal((4, 8, 6)).astype(np.float32))
    x = torch.from_numpy(g.standard_normal((4, 2, 8)).astype(np.float32))
    pl = S.to_placements(S.P("model", "data", None), mesh)
    dw = distribute_tensor(w, mesh, pl).requires_grad_()
    dx = distribute_tensor(x, mesh, pl)
    with Log() as fwd:
        y = torch.einsum("egd,edf->egf", dx, S.data_gathered(dw))
    with Log() as bwd:
        (grad,) = torch.autograd.grad(y, dw, torch.ones_like(y))
    w.requires_grad_()
    (want,) = torch.autograd.grad(torch.einsum("egd,edf->egf", x, w), w,
                                  torch.ones((4, 2, 6)))
    return {"gather/fwd": np.array(fwd.ops), "gather/bwd": np.array(bwd.ops),
            "gather/placed": np.array(grad.placements == dw.placements),
            "gather/grad_ok": np.array(bool(torch.allclose(
                grad.full_tensor(), want, rtol=1e-6, atol=0)))}


def rank_main(rank, store_path, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models import vit as V
    from repro_torch.train import compression, elastic
    from repro_torch.train.checkpoint import CheckpointManager

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    mesh = make_mesh(SHAPE, AXES, device="cpu")
    out = {"coord": np.array(mesh.get_coordinate())}
    times = {}

    # local blocks of every leaf
    t0 = time.perf_counter()
    for arch in ARCHS:
        cfg = _cfg(arch)
        p = T.init(cfg, 0, "cpu")
        dp = S.distribute(p, S.param_shardings(p, mesh), mesh)
        for path, t in S.tree_paths(dp):
            out[f"block/{arch}/{path}"] = t.to_local().numpy()
    times["blocks"] = time.perf_counter() - t0

    # the built LM train step
    t0 = time.perf_counter()
    for gd in ("f32", "bf16"):
        cfg, _, spec = _lm_train_spec(gd, mesh)
        out.update(_flat(run_train(spec, T.init(cfg, 0, "cpu"),
                                   _lm_batch(cfg)), f"train/{gd}"))
    times["lm_train"] = time.perf_counter() - t0

    # one query head a rank: a (1, 4) mesh over the same ranks
    t0 = time.perf_counter()
    cfg, _, spec = _lm_train_spec("f32", make_mesh((1, WORLD), AXES,
                                                   device="cpu"),
                                  **HEAD_A_RANK)
    out.update(_flat(run_train(spec, T.init(cfg, 0, "cpu"),
                               _lm_batch(cfg), n_steps=1),
                     "train/head_a_rank"))
    times["lm_train_head_a_rank"] = time.perf_counter() - t0

    # moonshot's forward: routing and logits
    t0 = time.perf_counter()
    cfg = _cfg("moonshot-v1-16b-a3b")
    p = T.init(cfg, 0, "cpu")
    dp = S.distribute(p, S.param_shardings(p, mesh), mesh)
    toks, ref, ridx = moe_tokens(cfg, p)
    dt = S.distribute(toks, S.batch_spec(mesh), mesh)
    (logits, _), idx, _ = _routes(lambda: T.forward(dp, dt, cfg, mesh=mesh))
    out["moe/tokens"] = toks.numpy()
    out["moe/logits"] = S.full_tensor(logits).numpy()
    out["moe/ref_logits"] = ref.numpy()
    for i, (a, b) in enumerate(zip(idx, ridx)):
        out[f"moe/idx/{i}"], out[f"moe/ref_idx/{i}"] = a, b
    times["moe"] = time.perf_counter() - t0

    # moonshot's built train step: the experts' weights and gradients
    t0 = time.perf_counter()
    out.update(gather_collectives(mesh))
    cfg, _, spec = _moe_train_spec(mesh)
    p = T.init(cfg, 0, "cpu")
    out.update(_flat(run_train(spec, p, _moe_batch(cfg, p), n_steps=1),
                     "moe_train"))
    times["moe_train"] = time.perf_counter() - t0

    # the other families' serve steps: LM decode (the sharded cache
    # written in place), DiT's sampler, EfficientNet
    t0 = time.perf_counter()
    out.update(serve_steps(mesh))
    times["serve_steps"] = time.perf_counter() - t0

    # a ViT train step
    t0 = time.perf_counter()
    cfg, _, spec = _vit_train_spec(mesh)
    out.update(_flat(run_train(spec, V.init(cfg, 0, "cpu"), _vit_batch(cfg),
                               n_steps=1), "vit"))
    times["vit"] = time.perf_counter() - t0

    # an EfficientNet train step: batch norm over a sharded batch
    t0 = time.perf_counter()
    out.update(effnet_train(mesh))
    times["effnet_train"] = time.perf_counter() - t0

    # the train loop on the mesh: int8 error feedback, a sharded
    # checkpoint, and a resumed run
    t0 = time.perf_counter()
    out.update(_flat_loop(run_loop(mesh, os.path.join(out_dir, "loop"))))
    times["loop"] = time.perf_counter() - t0

    # apply_ef's scale over a whole sharded tensor
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (64, 48)).astype(np.float32))
    e = torch.zeros_like(g)
    pl = S.to_placements(S.P("data", "model"), mesh)
    from torch.distributed.tensor import distribute_tensor
    (dd,), (de,) = compression.apply_ef(
        [distribute_tensor(g, mesh, pl)], [distribute_tensor(e, mesh, pl)])
    (wd,), (we,) = compression.apply_ef([g], [e])
    out["apply_ef/ok"] = np.array(bool(torch.equal(dd.full_tensor(), wd))
                                  and bool(torch.equal(de.full_tensor(),
                                                       we)))

    # compressed_psum over each axis
    t0 = time.perf_counter()
    x = torch.from_numpy(np.random.default_rng(100 + rank).standard_normal(
        (64, 48)).astype(np.float32) * (1 + rank))
    out["psum/x"] = x.numpy()
    for axis in AXES:
        out[f"psum/{axis}"] = compression.compressed_psum(
            x, mesh, axis).numpy()
    times["psum"] = time.perf_counter() - t0

    # choose_mesh
    t0 = time.perf_counter()
    for n, mp_, pods in CHOOSE:
        try:
            shape = tuple(elastic.choose_mesh(list(range(n)), mp_,
                                              pods).shape)
        except ValueError:
            shape = ()
        out[f"choose/{n}/{mp_}/{pods}"] = np.array(shape, np.int64)
    times["choose"] = time.perf_counter() - t0

    # reshard, sharded save and restore
    t0 = time.perf_counter()
    cfg = _cfg("olmo-1b")
    p = T.init(cfg, 0, "cpu")
    specs = S.param_shardings(p, mesh)
    dp = S.distribute(p, specs, mesh)
    small = elastic.choose_mesh([0, 1])
    moved = elastic.reshard(dp, small)
    new_specs = S.param_shardings(p, small)
    ok = True
    for (path, t), (_, a), (_, s) in zip(S.tree_paths(moved),
                                         S.tree_paths(p),
                                         S.tree_paths(new_specs)):
        ok &= tuple(t.placements) == S.to_placements(s, small)
        if rank < 2:
            ok &= bool(torch.equal(t.full_tensor(), a))
        else:
            ok &= t.to_local().numel() == 0
    out["reshard/ok"] = np.array(ok)
    ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"),
                             async_save=True)
    ckpt.save(3, {"params": dp, "step": np.int32(3)}, extra={"k": 1})
    ckpt.wait()
    _, tree, extra = ckpt.restore(device="cpu",
                                  shardings={"params": specs, "step": None},
                                  mesh=mesh)
    ok = extra == {"k": 1}
    for (path, t), (_, a), (_, s) in zip(S.tree_paths(tree["params"]),
                                         S.tree_paths(p),
                                         S.tree_paths(specs)):
        ok &= tuple(t.placements) == S.to_placements(s, mesh)
        ok &= bool(torch.equal(t.full_tensor(), a))
    out["restore/ok"] = np.array(ok)
    times["checkpoint"] = time.perf_counter() - t0

    out["misses"] = np.array(S.CONSTRAIN_MISSES)
    out["times"] = np.array(json.dumps(times))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

_JAX_DEVICES = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.common.config import reduced
from repro.configs import get_arch
from repro.distributed.sharding import param_shardings, _key_str
from repro.models import transformer
from repro.train.elastic import choose_mesh
ARCHS, CHOOSE = json.loads(sys.argv[1]), json.loads(sys.argv[2])
devs = jax.devices()
mesh = Mesh(np.array(devs).reshape(2, 2), ("data", "model"))
out = {"blocks": {}, "choose": {}}
for arch in ARCHS:
    cfg = reduced(get_arch(arch), dtype="float32")
    shapes = jax.eval_shape(lambda: transformer.init(jax.random.PRNGKey(0),
                                                     cfg))
    shard = param_shardings(shapes, mesh)
    for (kp, leaf), s in zip(jax.tree_util.tree_flatten_with_path(shapes)[0],
                             jax.tree.leaves(shard)):
        path = "/".join(_key_str(k) for k in kp)
        idx = s.devices_indices_map(leaf.shape)
        out["blocks"][arch + "/" + path] = [
            [[sl.start or 0, leaf.shape[d] if sl.stop is None else sl.stop]
             for d, sl in enumerate(idx[dv])] for dv in devs]
for n, mp, pods in CHOOSE:
    try:
        m = choose_mesh(devs[:n], mp, pods)
        shape = list(m.devices.shape) if m.devices.size else []
    except Exception:
        shape = []
    out["choose"][f"{n}/{mp}/{pods}"] = shape
print(json.dumps(out))
"""


def _jax_devices_run():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen(
        [sys.executable, "-c", _JAX_DEVICES, json.dumps(ARCHS),
         json.dumps(CHOOSE)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _jax_train(arch, cfg, cell, batch, params, steps=2, **changes):
    """JAX's built train step of ``arch`` (olmo-1b or vit-s16: its reduced
    fp32 config with ``changes``, the LM's with ``cfg``'s micro-batches
    and reduce dtype, on a (1, 1) mesh) from the
    same weights, as ``run_train`` reports it (without ``after``)."""
    import jax
    import jax.numpy as jnp
    import repro.launch.steps as JST
    from repro.common.config import reduced as jreduced
    from repro.configs import get_arch as jget_arch
    from repro.launch.mesh import make_mesh as jmake_mesh
    from repro.train import optimizer as jopt
    from repro_torch.models import layers as L
    lm = arch == "olmo-1b"
    over = ({"train_microbatches": cfg.train_microbatches,
             "grad_reduce_dtype": cfg.grad_reduce_dtype} if lm else {})
    jcfg = jreduced(jget_arch(arch), dtype="float32", **over, **changes)
    build = JST.build_lm if lm else JST.build_vit
    fn = jax.jit(build(jcfg, cell, jmake_mesh((1, 1), AXES)).fn)
    jp = jax.tree.map(jnp.asarray, L.tree_to_jax(params))
    before = jax.tree.leaves(jp)
    jo = jopt.init(jp)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    f64 = lambda t: [np.asarray(x, np.float64) for x in jax.tree.leaves(t)]
    out = {"loss": [], "m": [], "v": []}
    for _ in range(steps):
        jp, jo, loss = fn(jp, jo, jb)
        out["loss"].append(float(loss))
        out["m"].append(f64(jo["m"]))
        out["v"].append(f64(jo["v"]))
    out["change"] = [a - b for a, b in zip(f64(jp), f64(before))]
    return out


def _jax_moe_logits(params, tokens):
    """JAX's forward of reduced moonshot (fp32) from the same weights."""
    import jax
    import jax.numpy as jnp
    from repro.common.config import reduced as jreduced
    from repro.configs import get_arch as jget_arch
    from repro.models import transformer as JT
    from repro_torch.models import layers as L
    jcfg = jreduced(jget_arch("moonshot-v1-16b-a3b"), dtype="float32")
    jp = jax.tree.map(jnp.asarray, L.tree_to_jax(params))
    return np.asarray(JT.forward(jp, jnp.asarray(tokens.numpy()), jcfg)[0])


# ---------------------------------------------------------------------------
# The run and its checks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the 4 ranks and the JAX subprocess, computes the unsharded
    references meanwhile; returns (each rank's npz, JAX's blocks and
    choose_mesh shapes, the references)."""
    from repro_torch.models import transformer as T
    from repro_torch.models import vit as V
    out_dir = str(tmp_path_factory.mktemp("mesh"))
    store = os.path.join(out_dir, "store")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), store, out_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    jproc = _jax_devices_run()

    refs = {}
    try:
        for gd in ("f32", "bf16"):
            cfg, cell, spec = _lm_train_spec(gd)
            params = T.init(cfg, 0, "cpu")
            batch = _lm_batch(cfg)
            refs[f"jax/{gd}"] = _jax_train("olmo-1b", cfg, cell, batch,
                                           params)
            refs[f"port/{gd}"] = run_train(spec, params, batch)
        cfg, cell, spec = _lm_train_spec("f32", **HEAD_A_RANK)
        params, batch = T.init(cfg, 0, "cpu"), _lm_batch(cfg)
        refs["jax/head_a_rank"] = _jax_train("olmo-1b", cfg, cell, batch,
                                             params, steps=1, **HEAD_A_RANK)
        refs["port/head_a_rank"] = run_train(spec, params, batch, n_steps=1)
        cfg, cell, spec = _vit_train_spec()
        params, batch = V.init(cfg, 0, "cpu"), _vit_batch(cfg)
        refs["jax/vit"] = _jax_train("vit-s16", cfg, cell, batch, params,
                                     steps=1)
        refs["vit"] = run_train(spec, params, batch, n_steps=1)
        cfg = _cfg("moonshot-v1-16b-a3b")
        params = T.init(cfg, 0, "cpu")
        toks = moe_tokens(cfg, params)[0]
        refs["jax/moe"] = (toks.numpy(), _jax_moe_logits(params, toks))
        cfg, _, spec = _moe_train_spec()
        params = T.init(cfg, 0, "cpu")
        refs["moe_train"] = run_train(spec, params, _moe_batch(cfg, params),
                                      n_steps=1)
        refs["loop"] = run_loop(None, os.path.join(out_dir, "ref_loop"))
        jout, jerr = jproc.communicate(timeout=300)
        assert jproc.returncode == 0, jerr[-3000:]
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs + [jproc]:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    npz = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
           for r in range(WORLD)]
    return npz, json.loads(jout), refs, out_dir


def test_constrain_misses_stay_zero(ranks):
    npz = ranks[0]
    assert [int(z["misses"]) for z in npz] == [0] * WORLD


def test_local_blocks_are_jax_slices(ranks):
    from repro_torch.distributed import sharding as S
    from repro_torch.models import transformer as T
    npz, jx = ranks[0], ranks[1]
    for arch in ARCHS:
        p = T.init(_cfg(arch), 0, "cpu")
        for path, t in S.tree_paths(p):
            full = t.numpy()
            slices = jx["blocks"][f"{arch}/{path}"]
            for r, z in enumerate(npz):
                d = int(z["coord"][0]) * 2 + int(z["coord"][1])
                want = full[tuple(slice(a, b) for a, b in slices[d])]
                np.testing.assert_array_equal(z[f"block/{arch}/{path}"],
                                              want, err_msg=path)


def _same_step(got, want, what, bf16=False):
    """The loss line within 1e-5 relative; each step's moments within
    ATOL of their leaf's largest |value|, and in bf16 also one bf16 ulp
    of each step's gradient (2**-7 in ``m``, 2**-6 in ``v``, as AdamW
    carries them: ``m_s = b1 m_(s-1) + (1 - b1) g_s``); each change
    within ATOL of its leaf's largest |change|, a tenth of each step's
    learning rate and one fp32 ulp of the new value per step
    (``tests/test_torch_steps.py``'s rule over two steps)."""
    from repro_torch.launch.steps import OPT_CFG
    from repro_torch.train import optimizer as opt
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                               err_msg=what)
    n = len(want["loss"])
    for key, b, ulp in (("m", OPT_CFG.b1, 2.0 ** -7),
                        ("v", OPT_CFG.b2, 2.0 ** -6)):
        for s in range(n):
            prev = want[key][s - 1] if s else [0.0] * len(want[key][s])
            for i, (g, w, p) in enumerate(zip(got[key][s], want[key][s],
                                              prev)):
                tol = ATOL * np.abs(w).max()
                if bf16:
                    # one ulp of this step's gradient, and the carried one
                    tol = tol + ulp * (np.abs(w - b * p) + b * np.abs(p))
                assert np.all(np.abs(g - w) <= tol), (what, key, s, i)
    lr = sum(opt.lr_at(OPT_CFG, s) for s in range(n))
    for i, (g, w, a) in enumerate(zip(got["change"], want["change"],
                                      want["after"] if "after" in want
                                      else got["after"])):
        tol = (ATOL * np.abs(w).max() + lr / 10
               + n * np.spacing(np.abs(a).astype(np.float32)))
        assert np.all(np.abs(g - w) <= tol), (what, "change", i)


@pytest.mark.parametrize("gd", ["f32", "bf16"])
def test_lm_train_step_on_the_mesh(ranks, gd):
    npz, _, refs, _ = ranks
    port = refs[f"port/{gd}"]
    for z in npz:
        got = dict(_unflat(z, f"train/{gd}"), after=port["after"])
        _same_step(got, port, f"{gd} vs unsharded", bf16=gd == "bf16")
        _same_step(got, refs[f"jax/{gd}"], f"{gd} vs JAX",
                   bf16=gd == "bf16")


def test_lm_train_step_one_head_a_rank(ranks):
    """Reduced olmo-1b's train step (d_model 256, 4 heads) on a (1, 4)
    mesh, one head on each model rank: its backward views the heads'
    gradient back into the projections' (ROADMAP C19). Within 1e-5 of
    the unsharded port step and of JAX's, by ``_same_step``'s rule."""
    npz, _, refs, _ = ranks
    port = refs["port/head_a_rank"]
    for z in npz:
        got = dict(_unflat(z, "train/head_a_rank", n_steps=1),
                   after=port["after"])
        _same_step(got, port, "one head a rank vs unsharded")
        _same_step(got, refs["jax/head_a_rank"], "one head a rank vs JAX")


def test_moe_forward_routes_as_unsharded(ranks):
    npz, _, refs, _ = ranks
    jtoks, jlogits = refs["jax/moe"]
    for z in npz:
        n = len([k for k in z if k.startswith("moe/idx/")])
        assert n == 2
        for i in range(n):
            np.testing.assert_array_equal(z[f"moe/idx/{i}"],
                                          z[f"moe/ref_idx/{i}"])
        np.testing.assert_array_equal(z["moe/tokens"], jtoks)
        for ref in (z["moe/ref_logits"], jlogits):
            assert np.abs(z["moe/logits"] - ref).max() <= \
                ATOL * np.abs(ref).max()


def test_data_gathered_backward_is_a_reduce_scatter(ranks):
    """``sharding.data_gathered`` all-gathers an expert weight over
    "data" and nothing else, and the backward of a product with it hands
    the gradient, a partial sum over "data", back on the weight's own
    placements by a reduce-scatter (FSDP's move), not an all-reduce
    (ROADMAP C26): equal to the unsharded gradient."""
    for z in ranks[0]:
        assert list(z["gather/fwd"]) == ["all_gather_into_tensor"]
        assert list(z["gather/bwd"]) == ["reduce_scatter_tensor"]
        assert bool(z["gather/placed"]) and bool(z["gather/grad_ok"])


def test_moe_train_step_on_the_mesh(ranks):
    """Reduced moonshot's built train_4k step (fp32, 4 micro-batches, 2
    groups each, one on each data rank), one step on the mesh: the
    experts' weights gathered over "data" before their products and
    their gradients handed back on their shards (ROADMAP C26), the
    experts' input and output moved as C24 moves them, and their
    gradients. Within 1e-5 of the unsharded port step by ``_same_step``'s
    rule, on tokens whose router top-k margin is at least ``MARGIN`` in
    every layer (C14)."""
    npz, _, refs, _ = ranks
    port = refs["moe_train"]
    for z in npz:
        got = dict(_unflat(z, "moe_train", n_steps=1), after=port["after"])
        _same_step(got, port, "moe train step vs unsharded")


@pytest.mark.parametrize("name", [d[0] for d in DECODES] + ["dit",
                                                             "effnet"])
def test_serve_steps_on_the_mesh(ranks, name):
    """Each output of the built serve step on the mesh within 1e-5 of its
    largest |value| of the unsharded step's: a decode's logits at each
    token and its K/V caches, written in place on their shards, with the
    cache laid out as ``CACHE_SPECS`` says (heads, or the sequence, over
    the model axis; the sequence over both axes)."""
    decodes = {d[0]: d[-1] for d in DECODES}
    for z in ranks[0]:
        n = len([k for k in z if k.startswith(f"serve/{name}/mesh/")])
        assert n == (decodes[name] + 2 if name in decodes else 1)
        if name in decodes:
            assert str(z[f"serve/{name}/spec"]) == CACHE_SPECS[name]
        for i in range(n):
            got = z[f"serve/{name}/mesh/{i}"]
            want = z[f"serve/{name}/unsharded/{i}"]
            assert np.abs(got - want).max() <= ATOL * np.abs(want).max()


def test_vit_train_step_on_the_mesh(ranks):
    npz, _, refs, _ = ranks
    for z in npz:
        got = dict(_unflat(z, "vit", n_steps=1), after=refs["vit"]["after"])
        _same_step(got, refs["vit"], "vit vs unsharded")
        _same_step(got, refs["jax/vit"], "vit vs JAX")


# EfficientNet's gradients, through training-mode batch norms summed in
# another order: chip_smoke.py's bound for them (vision_card_vs_cpu), 5e-5
# of each leaf's largest |grad|, and for the leaves whose gradient is zero
# in exact arithmetic (the project batch norms' biases) 1e-5 of the
# model's largest
EFFNET_GRAD_TOL = 5e-5


def test_effnet_train_step_on_the_mesh(ranks):
    """Reduced efficientnet-b7's built train step on the mesh, with the
    batch norm's means made whole before they meet the batch (ROADMAP
    C25): the loss and the new batch-norm state within 1e-5 of the
    unsharded step's largest |value| (the state: of all its leaves, as
    ``chip_smoke.py`` holds it, whose near-zero running means of
    normalised inputs are rounding), and AdamW's moments (the step's
    gradients) within ``EFFNET_GRAD_TOL`` of each leaf's largest |value|
    or 1e-5 of the model's, whichever is larger."""
    for z in ranks[0]:
        for part in ("loss", "state", "m", "v"):
            keys = [k for k in z if k.startswith(
                f"effnet_train/mesh/{part}/")]
            assert keys
            pairs = [(z[k], z[k.replace("/mesh/", "/unsharded/")], k)
                     for k in keys]
            model = max(np.abs(w).max() for _, w, _ in pairs)
            for got, want, k in pairs:
                tol = ATOL * model
                if part in ("m", "v"):
                    tol = max(EFFNET_GRAD_TOL * np.abs(want).max(), tol)
                assert np.abs(got - want).max() <= tol, k


@pytest.mark.parametrize("axis", ["data", "model"])
def test_compressed_psum_is_jax_bitwise(ranks, axis):
    import jax
    import jax.numpy as jnp
    from repro.train.compression import compressed_psum
    npz = ranks[0]
    dim = AXES.index(axis)
    groups = {}
    for r, z in enumerate(npz):
        other = tuple(int(c) for i, c in enumerate(z["coord"]) if i != dim)
        groups.setdefault(other, []).append(r)
    fn = jax.vmap(lambda x: compressed_psum(x, "i"), axis_name="i")
    for members in groups.values():
        members.sort(key=lambda r: int(npz[r]["coord"][dim]))
        xs = jnp.stack([npz[r]["psum/x"] for r in members])
        want = np.asarray(fn(xs))
        for j, r in enumerate(members):
            np.testing.assert_array_equal(npz[r][f"psum/{axis}"], want[j])


def test_choose_mesh_shapes_match_jax(ranks):
    npz, jx = ranks[0], ranks[1]
    for n, mp_, pods in CHOOSE:
        want = tuple(jx["choose"][f"{n}/{mp_}/{pods}"])
        for z in npz:
            assert tuple(z[f"choose/{n}/{mp_}/{pods}"]) == want, (n, mp_,
                                                                 pods)


def test_train_loop_on_the_mesh(ranks):
    """``train(..., mesh=)`` with int8 error feedback and a resumed run:
    the logged losses (steps 1, 2, then 3 after the resume) within 1e-5
    relative of the unsharded loop's, the final parameters within a
    tenth of the three steps' learning rates and an fp32 ulp a step
    (``_same_step``'s rule); ``apply_ef`` on a DTensor takes its scale
    over the whole tensor: bitwise the unsharded call."""
    from repro_torch.launch.steps import OPT_CFG
    from repro_torch.train import optimizer as opt
    npz, _, refs, _ = ranks
    losses, params = refs["loop"]
    lr = sum(opt.lr_at(OPT_CFG, s) for s in range(3))
    for z in npz:
        assert bool(z["apply_ef/ok"])
        np.testing.assert_allclose(z["loop/loss"], losses, rtol=1e-5)
        assert len(losses) == 3
        for i, w in enumerate(params):
            tol = lr / 10 + 3 * np.spacing(np.abs(w).astype(np.float32))
            assert np.all(np.abs(z[f"loop/param/{i}"] - w) <= tol), i


def test_reshard_and_sharded_checkpoint(ranks):
    from repro_torch.models import transformer as T
    from repro_torch.train.checkpoint import CheckpointManager
    npz, _, _, out_dir = ranks
    assert all(bool(z["reshard/ok"]) for z in npz)
    assert all(bool(z["restore/ok"]) for z in npz)
    # the sharded save's bytes are an unsharded save's of the same values
    p = T.init(_cfg("olmo-1b"), 0, "cpu")
    ref = CheckpointManager(os.path.join(out_dir, "ref_ckpt"),
                            async_save=False)
    ref.save(3, {"params": p, "step": np.int32(3)}, extra={"k": 1})
    d = "step_00000003"
    for name in ("manifest.json", "tree.json"):
        with open(os.path.join(out_dir, "ckpt", d, name)) as f, \
                open(os.path.join(out_dir, "ref_ckpt", d, name)) as g:
            assert f.read() == g.read()
    with np.load(os.path.join(out_dir, "ckpt", d, "leaves.npz")) as a, \
            np.load(os.path.join(out_dir, "ref_ckpt", d, "leaves.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
