"""Sharding rules of the port: the parameter half (FSDP + TP + EP + SP on
a (pod, data, model) mesh) and the ingest half (stream-slot blocks).

The parameter half ports ``repro.distributed.sharding`` onto
``torch.distributed``'s ``DeviceMesh`` and DTensor, in JAX's two levels:

- A **spec** is a tuple with one entry per tensor dimension: a mesh axis
  name, ``None`` (whole), or a tuple of names (the dimension split over
  those axes, major to minor), what JAX's ``PartitionSpec`` holds. Specs
  are computed from a mesh's axis names and sizes alone, so an
  ``AbstractMesh`` of 512 devices gives the production specs in one
  process, as JAX's ``AbstractMesh`` does. ``mesh_axes``,
  ``spec_for_param``, ``param_shardings``, ``batch_spec`` and
  ``act_spec`` compute them with JAX's rules.
- A **placement** exists only on a real ``DeviceMesh``: ``to_placements``
  turns a spec into DTensor's ``Shard``/``Replicate`` per mesh dimension
  (a dimension split over ``("pod", "data")`` is ``Shard(d)`` on both,
  pod first), ``distribute`` lays a tree out by its specs, and
  ``constrain`` redistributes an activation to ``act_spec(mesh, kind)``.

Design (DESIGN.md §5):
  * TP  : attention heads, MLP hidden, vocab        -> "model"
  * EP  : MoE expert dim                            -> "model"
  * FSDP: the non-TP major dim of every weight      -> "data" (+"pod")
  * DP  : batch                                     -> ("pod","data")
  * SP  : long-context KV cache sequence dim        -> "model"

Where ``constrain`` cannot apply (a plain tensor under a mesh, or a spec
of another rank) it returns ``x`` unchanged, as JAX's does, and counts
the case in ``CONSTRAIN_MISSES``: under a mesh every activation is a
DTensor, so a miss is a constant that escaped the mesh. Tests and the
chip smoke hold the count at 0.

The ingest half (``SlotBlock``, ``ingest_layout``, ``stacked_state``)
lays multi-stream ingest out (DESIGN.md §13): the pipeline stacks
per-stream tensors along a leading stream-slot axis (crops ``(S, B, R,
R, 3)``, centroids ``(S, M, D)``, counts ``(S, M)``, live counts ``n
(S,)`` and fold rows ``(S, B)``), and each device of the 1-D
``("data",)`` ingest mesh owns a contiguous, device-major block of those
slots for the whole run. A block is a slice of slots and its device,
computed once per pipeline, never per step.
"""
from __future__ import annotations

import math
import re
import sys
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch



class P(tuple):
    """A spec: JAX's ``PartitionSpec``, a tuple with one entry per tensor
    dimension (a mesh axis name, ``None``, or a tuple of names). A type
    of its own, so that trees of specs can nest tuples of arguments."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


Spec = P

# constrain() calls that returned x unchanged under a mesh
CONSTRAIN_MISSES = 0


# ---------------------------------------------------------------------------
# Meshes: names and sizes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no device behind it: what the
    specs are computed from (JAX's ``jax.sharding.AbstractMesh``)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names: an ``AbstractMesh``'s, or a ``DeviceMesh``'s
    ``mesh_dim_names``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size}, in the mesh's order, as JAX's ``mesh.shape``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def is_device_mesh(mesh) -> bool:
    return mesh is not None and not isinstance(mesh, AbstractMesh)


def mesh_axes(mesh):
    """(dp, mp): the batch axis (``"data"``, or ``("pod", "data")`` when
    both exist, or None) and the model axis (``"model"`` or None)."""
    names = axis_names(mesh)
    dp = tuple(n for n in names if n in ("pod", "data"))
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    mp = "model" if "model" in names else None
    return dp, mp


def _axis_size(mesh, axis) -> int:
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        return math.prod(shape[a] for a in axis)
    return shape[axis]


def _divisible(dim: int, mesh, axis) -> bool:
    if axis is None or dim <= 0:
        return False
    return dim % _axis_size(mesh, axis) == 0


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# (regex on the param path, spec builder), JAX's table in JAX's order: the
# first match whose rank fits wins. A leading layer axis (scan over layers)
# is handled by prepending None when the tensor is stacked. Builders get
# the *unstacked* shape.
_RULES = [
    # token / positional embeddings: vocab|positions over model, d over fsdp
    (r"tok_embed$",        lambda s: ("model", "data")),
    (r"pos_embed$",        lambda s: (None, "data")),
    (r"label_embed$",      lambda s: (None, "data")),
    # attention projections
    (r"attn/wq$",          lambda s: ("data", "model")),
    (r"attn/wk$",          lambda s: ("data", "model")),
    (r"attn/wv$",          lambda s: ("data", "model")),
    (r"attn/wo$",          lambda s: ("model", "data")),
    # dense mlp
    (r"mlp/w(i|g)$",       lambda s: ("data", "model")),
    (r"mlp/wo$",           lambda s: ("model", "data")),
    # MoE: experts over model (EP), d_model over fsdp
    (r"moe/gate$",         lambda s: ("data", None)),
    (r"moe/w(i|g)$",       lambda s: ("model", "data", None)),
    (r"moe/wo$",           lambda s: ("model", None, "data")),
    # output head
    (r"head/w$",           lambda s: ("data", "model")),
    (r"head/b$",           lambda s: ("model",)),
    # DiT conditioning / modulation
    (r"adaln/w$",          lambda s: ("data", "model")),
    (r"adaln/b$",          lambda s: ("model",)),
    (r"t_embed/w\d$",      lambda s: ("data", "model") if s[-1] > s[0]
                                     else ("model", "data")),
    # patchify / conv stems: shard output channels over model
    (r"patch/w$",          lambda s: (None, None, "data", "model")),
    (r"patch/b$",          lambda s: ("model",)),
    (r"conv/w$",           lambda s: (None, None, "data", "model")),
    (r"dwconv/w$",         lambda s: (None, None, None, "model")),
    # norms / scalars / biases: replicated
    (r"(scale|bias|b|cls|dist)$", lambda s: tuple(None for _ in s)),
]


def spec_for_param(path: str, shape: tuple, mesh,
                   stacked: bool = False) -> Spec:
    """The spec of one parameter leaf at ``path`` ('/'-joined keys).

    ``stacked``: the leaf has a leading layer axis, which stays whole.
    Replicated where no rule matches; an axis that does not divide its
    dimension is dropped."""
    dp, mp = mesh_axes(mesh)
    shape = tuple(shape)
    rank = len(shape) - (1 if stacked else 0)
    base_shape = shape[1:] if stacked else shape
    spec: Optional[tuple] = None
    for pat, builder in _RULES:
        if re.search(pat, path):
            cand = builder(base_shape)
            if len(cand) == rank:
                spec = cand
                break
    if spec is None:
        spec = tuple(None for _ in range(rank))
    out = []
    for dim, ax in zip(base_shape, spec):
        if ax == "data":
            ax = dp
        elif ax == "model":
            ax = mp
        if ax is not None and not _divisible(dim, mesh, ax):
            ax = None
        out.append(ax)
    if stacked:
        out = [None] + out
    return P(*out)


def tree_paths(tree, prefix: str = ""):
    """(path, leaf) for every leaf of a tree of dicts, lists and tuples,
    in the JAX package's order (dict keys sorted); paths '/'-joined as
    JAX's ``tree_map_with_path`` keys print. A spec ``P`` is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}/{k}" if prefix
                                  else str(k))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _map_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, f"{prefix}/{i}" if prefix
                                     else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def param_shardings(params: Any, mesh, scan_layers: bool = True):
    """The tree of specs of a parameter tree (tensors, meta tensors, or
    anything with a ``shape``): JAX's ``param_shardings``. A leaf under a
    ``layers`` key is stacked when ``scan_layers``."""
    def visit(path, leaf):
        stacked = scan_layers and "/layers/" in ("/" + path + "/")
        return spec_for_param(path, tuple(leaf.shape), mesh, stacked=stacked)

    return _map_paths(visit, params)


# ---------------------------------------------------------------------------
# Activation rules
# ---------------------------------------------------------------------------

def batch_spec(mesh, extra_rank: int = 1) -> Spec:
    dp, _ = mesh_axes(mesh)
    return P(dp, *[None] * extra_rank)


_ACT = {
    "tokens": lambda dp, mp: (dp, None),                  # (B, S)
    "hidden": lambda dp, mp: (dp, None, None),            # (B, S, D)
    "hidden_sp": lambda dp, mp: (dp, mp, None),           # SP region
    "ffn": lambda dp, mp: (dp, None, mp),                 # (B, S, F)
    "heads": lambda dp, mp: (dp, None, mp, None),         # (B, S, H, dh)
    "scores": lambda dp, mp: (dp, mp, None, None),        # (B, H, Sq, Sk)
    "kv_cache": lambda dp, mp: (dp, mp, None, None),      # SP over sequence
    "kv_cache_heads": lambda dp, mp: (dp, None, mp, None),
    "logits": lambda dp, mp: (dp, None, mp),              # (B, S, V)
    "images": lambda dp, mp: (dp, None, None, None),      # (B, H, W, C)
    "replicated": lambda dp, mp: (),
    # the port's own, where JAX leaves the MoE to XLA's propagation:
    # token groups (G, gs, D) over every axis; expert buffers (E, G, C,
    # D) with the experts over "model" (EP) and the groups over the data
    # axes for the expert products, and laid out as the groups for the
    # combine. Between the layouts DTensor plans GShard's two all-to-alls
    "groups": lambda dp, mp: (_join(dp, mp), None, None),
    "experts": lambda dp, mp: (mp, dp, None, None),
    "expert_groups": lambda dp, mp: (None, _join(dp, mp), None, None),
}


def _join(*entries):
    """One spec entry over the axes of several (names, tuples, None)."""
    axes = tuple(a for e in entries if e is not None
                 for a in (e if isinstance(e, tuple) else (e,)))
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def act_spec(mesh, kind: str) -> Spec:
    """The common activation specs, JAX's ``act_spec``."""
    if kind not in _ACT:
        raise ValueError(kind)
    return P(*_ACT[kind](*mesh_axes(mesh)))


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh: placements, distribution, constraints
# ---------------------------------------------------------------------------

def to_placements(spec: Spec, device_mesh, shape=None) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh``: per mesh dim,
    ``Shard(d)`` where tensor dim d's entry names it, else
    ``Replicate()``. A tuple entry must list its axes in the mesh's order
    (major to minor), as every rule does. A mesh dim of size 1 splits
    nothing and is ``Replicate()`` (DTensor refuses to view a dimension
    sharded over it when the dimension has size 1).

    With the tensor's ``shape``, a dimension that its axes do not divide
    (a batch of 1 over 16 data ranks, 12 heads over 16 model ranks)
    keeps the largest of their products that divides it, and the other
    axes are ``Replicate()`` (a batch of 16 over ("pod", "data") = 32
    goes over "data"): XLA pads such a split to one row a device,
    DTensor cannot fold or split the uneven blocks it would make."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(device_mesh)
    sizes = mesh_shape(device_mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        idx = [i for i in idx if sizes[names[i]] > 1]
        if shape is not None:
            subsets = [[i for b, i in enumerate(idx) if m >> b & 1]
                       for m in range(1 << len(idx))]
            idx = max((c for c in subsets if shape[d] % math.prod(
                sizes[names[i]] for i in c) == 0),
                key=lambda c: math.prod(sizes[names[i]] for i in c))
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether x is a DTensor. No DTensor exists before
    ``torch.distributed.tensor`` is imported, so a plain path does not
    import it (~1.3 s)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def distribute(tree: Any, specs: Any, device_mesh):
    """Every tensor leaf of ``tree`` as a DTensor on ``device_mesh``, laid
    out by the matching spec of ``specs`` (a tree of the same structure;
    ``()`` replicates any leaf, ``None`` leaves a leaf or a subtree as it
    is). Leaves that are not tensors (a Python step count) pass through.
    Every rank passes the same full values: each takes its own shard of
    them, with no collective."""
    from torch.distributed.tensor import distribute_tensor

    def walk(t, s):
        if s is None:
            return t
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, sv) for v, sv in zip(t, s))
        if not isinstance(t, torch.Tensor):
            return t
        if is_dtensor(t):
            return t.redistribute(device_mesh, to_placements(s, device_mesh))
        return distribute_tensor(t, device_mesh,
                                 to_placements(s, device_mesh),
                                 src_data_rank=None)

    return walk(tree, specs)


def full_tensor(tree: Any):
    """Every DTensor leaf of ``tree`` gathered whole (a collective on
    every rank of its mesh); other leaves as they are."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return t.full_tensor() if is_dtensor(t) else t
    return walk(tree)


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor a layer made itself (positions, rope tables, masks,
    one-hots), as a replicated DTensor on ``like``'s mesh when ``like`` is
    a DTensor; else ``t`` itself. Every rank makes the same ``t``."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _GradLike(torch.autograd.Function):
    """The identity on a DTensor, whose gradient is redistributed to the
    DTensor's own placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        mesh, pl = g.device_mesh, ctx.placements
        cut = {p.dim for p, q in zip(pl, g.placements)
               if isinstance(p, Shard) and p != q}
        if not all(isinstance(q, Replicate) or p == q
                   for p, q in zip(pl, g.placements)) or any(
                isinstance(q, Shard) and q.dim in cut for q in g.placements):
            return g.redistribute(mesh, pl)
        # g is whole along the dims x splits: each rank cuts its block
        # out of its local tensor (a view: a whole expanded gradient is
        # never copied, as redistribute would copy it)
        shape, off = compute_local_shape_and_global_offset(g.shape, mesh, pl)
        loc = g.to_local()
        for d in cut:
            loc = loc.narrow(d, off[d], shape[d])
        return DTensor.from_local(loc, mesh, pl, run_check=False,
                                  shape=g.shape, stride=g.stride())


def grad_like(x: torch.Tensor) -> torch.Tensor:
    """x, whose gradient arrives laid out as x: a DTensor's sum over a
    sharded dimension hands back a gradient whole on every rank (its
    expansion), which the next op would gather whole; redistributed, each
    rank keeps its block. A plain tensor passes as it is."""
    return _GradLike.apply(x) if is_dtensor(x) else x


class _LogSumExp(torch.autograd.Function):
    """logsumexp over the last dim from its max and its sum, reductions
    DTensor keeps on a sharded dim (all-reduced), where its own
    logsumexp gathers the dim whole. torch's formula, step for step (an
    infinite max taken as 0), and its gradient, ``g * exp(x - lse)``,
    which stays sharded as x."""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(-1, keepdim=True)
        m = m.masked_fill(m.abs() == math.inf, 0)
        lse = torch.log(torch.exp(x - m).sum(-1)) + m[..., 0]
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * (x - lse[..., None]).exp()


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, -1)``, bit for bit, of a plain tensor or a
    DTensor (without gathering the dim)."""
    return _LogSumExp.apply(x)


def onehot_like(labels: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``labels[..., None] == arange(V)`` in x's dtype, the (..., V)
    one-hot of x's last dim, laid out as x when x is a DTensor: each rank
    compares its block of the labels with its block of the vocabulary,
    so no rank makes the whole one-hot (DTensor's rule for ``==`` can
    broadcast the vocabulary whole: on the (16, 16) mesh, 16.5 GB a
    device for olmo-1b's train_4k on torch 2.11, 13.6 GB for
    moonshot's on 2.13)."""
    def onehot(lab, vocab):
        return (lab[..., None].long() == vocab).to(x.dtype)

    vocab = torch.arange(x.shape[-1], device=x.device)
    if not is_dtensor(x):
        return onehot(labels, vocab)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    last = x.dim() - 1
    splits_v = [isinstance(p, Shard) and p.dim == last for p in x.placements]
    lab = tuple(Replicate() if s else p
                for s, p in zip(splits_v, x.placements))
    voc = tuple(Shard(0) if s else Replicate() for s in splits_v)
    vocab = distribute_tensor(vocab, x.device_mesh, voc, src_data_rank=None)
    return local_map(onehot, out_placements=(x.placements,),
                     in_placements=(lab, voc), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(labels, vocab)


def gathered(t: torch.Tensor) -> torch.Tensor:
    """A DTensor whole on every rank (FSDP's all-gather of a weight before
    its use); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)


class _Whole(torch.autograd.Function):
    """``gathered`` whose gradient is made whole too."""

    @staticmethod
    def forward(ctx, x):
        return gathered(x)

    @staticmethod
    def backward(ctx, g):
        return gathered(g)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor whole on every rank, its gradient whole as well; a plain
    tensor as it is. For a statistic reduced over a sharded dim (a
    ``Partial(avg)`` mean), whose gradient DTensor cannot hand back as a
    ``Partial(avg)`` (it arrives as a partial sum)."""
    return _Whole.apply(t) if is_dtensor(t) else t


def data_gathered(t: torch.Tensor) -> torch.Tensor:
    """A DTensor weight whole over the mesh axes that split it for FSDP
    (``"data"``, and ``"pod"`` where the mesh has it), every other
    placement kept (an expert weight stays split over ``"model"``):
    FSDP's all-gather before the weight's use, as XLA gathers it. The
    redistribute's own backward hands the gradient, a partial sum over
    those axes, back on the weight's placements: FSDP's reduce-scatter.
    A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if name in ("pod", "data") else p
               for name, p in zip(t.device_mesh.mesh_dim_names,
                                  t.placements))
    return t.redistribute(t.device_mesh, pl)


def on_blocks(fn, placements: tuple, *ts: torch.Tensor, n_out: int = 1):
    """``fn`` on each rank's local blocks of the DTensors ``ts``, each
    first redistributed to ``placements``: for an op that is local on
    that layout (attention on blocks of batch and heads, a top-k on
    blocks of rows). The ``n_out`` outputs are DTensors of the same
    placements (``torch.distributed.tensor.experimental.local_map``;
    gradients flow back block for block).

    Each block's gradient leaves ``fn`` contiguous. An einsum's backward
    hands a block a strided gradient (attention's q: batch, head_dim,
    sequence in memory); where a mesh dimension leaves a block one row of
    a dimension (one head a rank), that row's stride says nothing, and
    DTensor's reshape of the gradient, planned on the global strides it
    infers from the block's, takes a view the block cannot give (the
    backward of ``(x @ wq).reshape(B, S, H, hd)`` and of the product
    before it)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = ts[0].device_mesh

    def dense(*blocks):
        return fn(*(_DenseGrad.apply(b) if b.requires_grad else b
                    for b in blocks))

    return local_map(dense, out_placements=(placements,) * n_out,
                     in_placements=(placements,) * len(ts),
                     device_mesh=mesh, redistribute_inputs=True)(*ts)


def write_slot(cache: torch.Tensor, slot: int, value: torch.Tensor):
    """``cache[:, slot] = value`` in place: a (B, S, ...) cache, a (B, ...)
    value. On a DTensor cache each rank writes into its own block, where
    its block of the sequence holds ``slot``, its block of ``value`` (laid
    out as the cache's other dimensions): a cache sharded over its
    sequence (SP) is written by the ranks that own the slot, and no rank
    moves the cache. (DTensor would index a sharded sequence on a
    redistributed copy and leave the cache as it was.)"""
    if not is_dtensor(cache):
        cache[:, slot] = value.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = cache.device_mesh, cache.placements
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh,
                                                          pl)
    # value is the cache without its dim 1: the cache's dim d > 1 is its
    # d - 1, and a mesh dim that splits the sequence holds it whole
    vpl = tuple(Replicate() if not isinstance(p, Shard) or p.dim == 1
                else Shard(p.dim - 1) if p.dim > 1 else p for p in pl)
    if not is_dtensor(value):
        value = replicate_like(value, cache)
    local = value.redistribute(mesh, vpl).to_local()
    # a rank outside the mesh has no offset and no block
    if offset and 0 <= slot - offset[1] < shape[1]:
        cache.to_local()[:, slot - offset[1]] = local.to(cache.dtype)


def unflatten(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x.reshape`` with dimension ``dim`` split into ``sizes`` (a
    projection into heads, heads into KV groups). DTensor splits a
    dimension only where its shards hold whole rows of ``sizes[0]``: on a
    DTensor, a mesh dimension that shards ``dim`` and does not divide
    ``sizes[0]`` (16 model ranks, 8 KV heads) gathers it first, as XLA
    reshards such a reshape."""
    dim = dim % x.dim()
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        pl, n = list(x.placements), 1
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim == dim:
                if sizes[0] % (n * x.device_mesh.size(i)):
                    pl[i] = Replicate()
                else:
                    n *= x.device_mesh.size(i)
        if tuple(pl) != tuple(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def splits(x: torch.Tensor, dim: int) -> bool:
    """Whether a mesh dimension shards the DTensor x's ``dim``."""
    from torch.distributed.tensor import Shard
    return any(isinstance(p, Shard) and p.dim == dim for p in x.placements)


def heads_placements(x: torch.Tensor) -> tuple:
    """``act_spec(mesh, "heads")``'s placements on x's mesh: (B, S, H, dh)
    with the batch over the data axes and the heads over ``"model"``,
    where they divide (``to_placements``)."""
    return to_placements(act_spec(x.device_mesh, "heads"), x.device_mesh,
                         x.shape)


def rows_placements(x: torch.Tensor) -> tuple:
    """x's placements with its rows (dim 0) kept where they are sharded
    and every other dimension whole."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)


def by_rows(fn, x: torch.Tensor, *weights: torch.Tensor) -> torch.Tensor:
    """``fn(x, *weights)`` for an op DTensor has no sharding rule for (a
    convolution): each rank applies ``fn`` to its block of x's rows
    (``rows_placements``) and to the whole weights; the output is sharded
    as x's rows. A weight's gradient is a partial sum over the mesh dims
    that split the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    rows = rows_placements(x)
    whole = (Replicate(),) * mesh.ndim
    grads = tuple(Partial() if isinstance(p, Shard) else Replicate()
                  for p in rows)
    return local_map(fn, out_placements=(rows,),
                     in_placements=(rows,) + (whole,) * len(weights),
                     in_grad_placements=(rows,) + (grads,) * len(weights),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, *weights)


def constrain(x, mesh, kind: str):
    """``x`` redistributed to ``act_spec(mesh, kind)`` on a DeviceMesh
    (an axis that does not divide its dimension left whole,
    ``to_placements``); with no mesh, or an abstract one, ``x``. Where
    the constraint cannot apply (x is no DTensor, or the spec's rank is
    not x's) x comes back unchanged, as JAX's ``constrain`` returns it,
    and the case is counted in ``CONSTRAIN_MISSES``."""
    global CONSTRAIN_MISSES
    if not is_device_mesh(mesh):
        return x
    spec = act_spec(mesh, kind)
    if not is_dtensor(x) or (spec and len(spec) != x.dim()):
        CONSTRAIN_MISSES += 1
        return x
    return x.redistribute(mesh, to_placements(spec, mesh, x.shape))


# ---------------------------------------------------------------------------
# Sharded ingest layout (DESIGN.md §13)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SlotBlock:
    """Slots ``[lo, hi)`` of the stacked stream axis, on ``device``: the
    ``index``-th entry of the mesh's ``"data"`` axis."""
    index: int
    device: torch.device
    lo: int
    hi: int

    @property
    def width(self) -> int:
        return self.hi - self.lo

    @property
    def slots(self) -> range:
        return range(self.lo, self.hi)


def ingest_layout(mesh, n_slots: int) -> Tuple[SlotBlock, ...]:
    """The mesh's blocks for ``n_slots`` stream slots: ``mesh.size``
    contiguous blocks of ``n_slots // mesh.size`` slots each, block i on
    ``mesh.devices[i]``."""
    if n_slots < 1 or n_slots % mesh.size:
        raise ValueError(f"n_slots={n_slots} must be a non-zero multiple of "
                         f"the mesh size {mesh.size} (pad with None)")
    width = n_slots // mesh.size
    return tuple(SlotBlock(i, dev, i * width, (i + 1) * width)
                 for i, dev in enumerate(mesh.devices))


def stacked_state(block: SlotBlock, max_clusters: int, feat_dim: int):
    """A block's zeroed cluster tables, stacked over its slots on its
    device: centroids (W, M, D) f32, counts (W, M) i32, n (W,) i32."""
    from repro_torch.core.clustering import ClusterState
    W, dev = block.width, block.device
    return ClusterState(
        centroids=torch.zeros((W, max_clusters, feat_dim),
                              dtype=torch.float32, device=dev),
        counts=torch.zeros((W, max_clusters), dtype=torch.int32,
                           device=dev),
        n=torch.zeros((W,), dtype=torch.int32, device=dev))
