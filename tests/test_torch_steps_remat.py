"""The remat policies ``dots`` and ``dots_nobatch`` (``models.layers``) on
the CPU, on reduced olmo-1b, granite-34b and moonshot-v1-16b-a3b in their
configs' bf16 (``tests/test_torch_train_lm.py`` holds their loss and
gradients bitwise equal to remat off).

- What a forward keeps for the backward: the tensors autograd saves,
  counted by a ``torch.autograd.graph.saved_tensors_hooks`` pack hook
  around the forward, plus the product outputs the selective checkpoint
  keeps. Inside a checkpointed layer autograd saves through the
  checkpoint's own hooks, which store nothing, and torch keeps the
  policy's outputs in its selective-checkpoint cache, past any hook: so
  that cache is read after the forward. Ordered ``nothing`` <
  ``dots_nobatch`` < ``dots``, with the hooked bytes equal under all
  three.
- ``dots_nobatch`` keeps only the outputs of products without batch dims
  in the JAX package (``mm``): no attention score or ``p.v`` and no MoE
  dispatch, expert or combine einsum (``bmm``, whose ``g``/``e``/``b``,
  ``h`` axes are batch dims in JAX); ``dots`` keeps those too, the fp32
  scores among them. A 3-D operand that ``torch.matmul`` cannot fold
  (a transposed one) multiplies a weight expanded over the batch in a
  ``bmm``: still a product with no batch dims, and kept.
- The built train step under the three policies: loss, parameters and
  AdamW's moments bitwise equal.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.common.config import LM_SHAPES, reduced
from repro_torch.configs import get_arch
from repro_torch.launch import steps as ST
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import param_leaves

POLICIES = ("nothing", "dots_nobatch", "dots")
B, S = 2, 32


def _cfg(arch, policy="nothing"):
    return reduced(get_arch(arch), remat=True, remat_policy=policy)


def _batch(cfg, seed=4):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return torch.from_numpy(toks), torch.from_numpy(np.roll(toks, -1, 1))


def _kept(cfg, params, monkeypatch):
    """One forward of ``loss_fn`` with gradients wanted: ``(hooked bytes,
    [(op, tensor)] the selective checkpoints keep)``; storages counted
    once."""
    caches = []
    real = L.create_selective_checkpoint_contexts

    def capture(policy):
        fwd, recompute = real(policy)
        caches.append(fwd.storage)
        return fwd, recompute
    monkeypatch.setattr(L, "create_selective_checkpoint_contexts", capture)
    hooked = {}

    def pack(t):
        st = t.untyped_storage()
        hooked[st.data_ptr()] = st.nbytes()
        return t

    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    toks, labels = _batch(cfg)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = T.loss_fn(params, toks, labels, cfg)
    kept = []
    for cache in caches:
        for op, entries in cache.items():
            for e in entries.values():
                val = getattr(e, "val", None)       # else: recomputed
                if isinstance(val, torch.Tensor):
                    kept.append((op, val))
    torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    monkeypatch.undo()
    return sum(hooked.values()), kept


def _bytes(kept):
    return sum(t.numel() * t.element_size() for _, t in kept)


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-34b"])
def test_saved_bytes_ordered(arch, monkeypatch):
    params = T.init(_cfg(arch), seed=0, device="cpu")
    got = {p: _kept(_cfg(arch, p), params, monkeypatch) for p in POLICIES}
    hooked = {p: h for p, (h, _) in got.items()}
    assert len(set(hooked.values())) == 1, hooked
    total = {p: h + _bytes(k) for p, (h, k) in got.items()}
    assert not got["nothing"][1]
    assert total["nothing"] < total["dots_nobatch"] < total["dots"], total


def test_dots_nobatch_keeps_no_batched_product(monkeypatch):
    """Reduced moonshot: 4 heads, 4 experts top-2, groups of 32 tokens."""
    cfg = _cfg("moonshot-v1-16b-a3b")
    params = T.init(cfg, seed=0, device="cpu")
    aten = torch.ops.aten
    scores = (B * cfg.n_heads, S, S)
    _, nobatch = _kept(dataclasses.replace(cfg, remat_policy="dots_nobatch"),
                       params, monkeypatch)
    _, dots = _kept(dataclasses.replace(cfg, remat_policy="dots"), params,
                    monkeypatch)
    assert {op for op, _ in nobatch} == {aten.mm.default}
    assert not any(tuple(t.shape) == scores for _, t in nobatch)
    batched = [t for op, t in dots if op is aten.bmm.default]
    # per layer: q.k^T (fp32) and p.v; dispatch, three expert products and
    # combine
    assert len(batched) == cfg.n_layers * 7
    assert sum(tuple(t.shape) == scores and t.dtype == torch.float32
               for t in batched) == cfg.n_layers
    # the expert products, batched over the experts; the dispatch and the
    # combine over the G = 2 groups
    experts = [t for t in batched if t.shape[0] == cfg.n_experts]
    assert len(experts) == cfg.n_layers * 3
    assert sum(t.shape[0] == B * S // 32 for t in batched) == \
        cfg.n_layers * 2
    assert [t for op, t in dots if op is aten.mm.default] != []


class _Products(TorchDispatchMode):
    """Records the (op, args) of every matrix product dispatched."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.seen.append((func, args))
        return func(*args, **(kwargs or {}))


def test_unfolded_matmul_counts_as_no_batch_product():
    x = torch.randn(8, 4, 16).transpose(0, 1)       # (4, 8, 16), strided
    w = torch.randn(16, 32)
    with _Products() as rec:
        x.requires_grad_(True) @ w
        torch.einsum("bqd,bkd->bqk", x, x)
    (f1, a1), (f2, a2) = rec.seen
    assert f1 is f2 is torch.ops.aten.bmm.default
    assert a1[1].stride(0) == 0                     # w expanded
    keep = CheckpointPolicy.MUST_SAVE
    nobatch, dots = L.remat_policy("dots_nobatch"), L.remat_policy("dots")
    assert nobatch(None, f1, *a1) == keep
    assert nobatch(None, f2, *a2) == CheckpointPolicy.PREFER_RECOMPUTE
    assert dots(None, f1, *a1) == dots(None, f2, *a2) == keep


@pytest.mark.parametrize("arch", ["olmo-1b", "moonshot-v1-16b-a3b"])
def test_built_train_step_policies_bitwise(arch):
    """moonshot in 2 micro-batches of 2 x 32 tokens."""
    cell = dataclasses.replace(LM_SHAPES["train_4k"], seq_len=S,
                               global_batch=4)
    toks = np.random.default_rng(5).integers(0, 256, (4, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, 1))}
    runs = {}
    for policy in POLICIES:
        cfg = dataclasses.replace(_cfg(arch, policy), train_microbatches=2)
        params = T.init(cfg, seed=0, device="cpu")
        spec = ST.build_lm(cfg, cell)
        params, state, loss = spec.fn(params, opt.init(param_leaves(params)),
                                      batch)
        runs[policy] = [loss] + param_leaves(params) + state["m"] \
            + state["v"]
    for policy in POLICIES[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs["nothing"],
                                                     runs[policy])), policy
