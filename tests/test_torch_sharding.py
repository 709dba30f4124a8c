"""The port's sharding specs (``repro_torch.distributed.sharding``,
``launch.steps``' shardings, ``launch.mesh``) against the JAX package's,
in one process with no devices: JAX's specs come from
``jax.sharding.AbstractMesh`` meshes, the port's from ``AbstractMesh``
(the same names and sizes), as the JAX package computes its 256- and
512-device layouts without the devices.

- Every parameter leaf of the 10 registry archs at full size (the port's
  shapes from a meta ``init``, JAX's from ``jax.eval_shape``), on the
  meshes (16, 16), (2, 16, 16), (2, 2) and (1, 1): the shapes and the
  ``param_shardings`` specs equal, JAX's ``PartitionSpec`` padded with
  None to the tensor's rank.
- ``act_spec`` for every kind (an unknown one raises), ``batch_spec``,
  ``mesh_axes``, and ``_residual_kind`` for each LM arch, cell and mesh.
- Every registry cell's ``in_shardings``/``out_shardings`` on (16, 16)
  (the long cells also as the window variant, and olmo-1b under
  ``ddp_zero1``, vit-l16 under ``serve_pure_dp``), and one arch per
  family on (2, 16, 16), leaf for leaf JAX's ``build(arch, cell,
  AbstractMesh)``.
- Shard shapes on (2, 2): the block DTensor gives each mesh coordinate
  under the port's placements (``to_placements``) equals JAX's
  ``NamedSharding(mesh, spec).shard_shape`` for every leaf.
- ``launch.mesh``: importing it starts no process group; a shape that is
  not the world size raises, and so does ``device="cuda"`` without a card.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset

import repro.distributed.sharding as JS
import repro.launch.steps as JST
from repro.configs import get_arch as jget_arch
from repro.models import dit as JD
from repro.models import efficientnet as JE
from repro.models import transformer as JT
from repro.models import vit as JV
from repro_torch.common.config import DiTConfig, EffNetConfig, LMConfig
from repro_torch.configs import ARCH_IDS, get_arch, get_shapes
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.models import dit, efficientnet, transformer, vit

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
KINDS = ("tokens", "hidden", "hidden_sp", "ffn", "heads", "scores",
         "kv_cache", "kv_cache_heads", "logits", "images", "replicated")
# one arch per family, for the 512-device step shardings
FAMILIES = ("olmo-1b", "moonshot-v1-16b-a3b", "dit-s2", "vit-s16",
            "efficientnet-b7")


def _meshes(name):
    sizes, names = MESHES[name]
    return M.make_abstract_mesh(sizes, names), JAbstractMesh(sizes, names)


def _norm(spec, rank):
    """A spec as a tuple of ``rank`` entries: 1-tuples as their name."""
    out = []
    for e in tuple(spec) + (None,) * (rank - len(spec)):
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else (e or None)
        out.append(e)
    return tuple(out)


def _port_leaves(tree):
    """(leaves, in JAX's order); a spec ``P`` is a leaf."""
    if isinstance(tree, S.P) or tree is None:
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _port_leaves(v)]
    return [tree]


def _port_params(arch):
    """(params, state or None, scan_layers) on the meta device."""
    cfg = get_arch(arch)
    if isinstance(cfg, LMConfig):
        return transformer.init(cfg, device="meta"), None, True
    if isinstance(cfg, DiTConfig):
        return dit.init(cfg, device="meta"), None, True
    if isinstance(cfg, EffNetConfig):
        p, s = efficientnet.init(cfg, device="meta")
        return p, s, False
    return vit.init(cfg, device="meta"), None, True


def _jax_params(arch):
    cfg = jget_arch(arch)
    key = jax.random.PRNGKey(0)
    mod = {LMConfig: JT, DiTConfig: JD, EffNetConfig: JE}.get(
        type(get_arch(arch)), JV)
    out = jax.eval_shape(lambda: mod.init(key, cfg))
    return out if mod is JE else (out, None)


@pytest.fixture(scope="module")
def jax_params():
    return {a: _jax_params(a) for a in ARCH_IDS}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, mesh_name, jax_params):
    pm, jm = _meshes(mesh_name)
    p, st, scan = _port_params(arch)
    jp, jst = jax_params[arch]
    for tree, jtree in ((p, jp), (st, jst)):
        if tree is None:
            continue
        got = S.param_shardings(tree, pm, scan_layers=scan)
        want = JS.param_shardings(jtree, jm, scan_layers=scan)
        leaves, jleaves = _port_leaves(tree), jax.tree.leaves(jtree)
        specs, jspecs = _port_leaves(got), jax.tree.leaves(want)
        paths = [pa for pa, _ in S.tree_paths(tree)]
        jpaths = ["/".join(JS._key_str(k) for k in kp) for kp, _ in
                  jax.tree_util.tree_flatten_with_path(jtree)[0]]
        assert paths == jpaths
        assert len(specs) == len(jspecs) == len(leaves)
        for path, t, jt, s, js in zip(paths, leaves, jleaves, specs, jspecs):
            assert tuple(t.shape) == jt.shape, path
            assert _norm(s, t.dim()) == _norm(js.spec, t.dim()), path
            assert S.spec_for_param(path, tuple(t.shape), pm,
                                    stacked=scan and "/layers/" in
                                    "/" + path + "/") == s


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_activation_specs_match_jax(mesh_name):
    pm, jm = _meshes(mesh_name)
    assert S.mesh_axes(pm) == JS.mesh_axes(jm)
    for kind in KINDS:
        want = JS.act_spec(jm, kind)
        assert _norm(S.act_spec(pm, kind), len(want)) == _norm(want,
                                                               len(want))
    with pytest.raises(ValueError):
        S.act_spec(pm, "nonsense")
    for extra in (0, 1, 3):
        assert _norm(S.batch_spec(pm, extra), extra + 1) == _norm(
            JS.batch_spec(jm, extra), extra + 1)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_residual_kind_matches_jax(mesh_name):
    pm, jm = _meshes(mesh_name)
    for arch in ARCH_IDS:
        cfg = get_arch(arch)
        if not isinstance(cfg, LMConfig):
            continue
        for name, cell in get_shapes(arch).items():
            for act in ("auto", "dp", "sp"):
                c = dataclasses.replace(cfg, act_sharding=act)
                jc = dataclasses.replace(jget_arch(arch), act_sharding=act)
                assert transformer._residual_kind(c, pm, cell.seq_len) == \
                    JT._residual_kind(jc, jm, cell.seq_len), (arch, name)
        assert transformer._residual_kind(cfg, None, 4096) == "hidden"


def _cells():
    out = []
    for arch in ARCH_IDS:
        for name, cell in get_shapes(arch).items():
            out.append((arch, name, None, None))
            if cell.kind == "long":
                out.append((arch, name, "window", None))
    out.append(("olmo-1b", "train_4k", None, {"parallelism": "ddp_zero1"}))
    out.append(("olmo-1b", "prefill_32k", None,
                {"parallelism": "ddp_zero1"}))
    out.append(("olmo-1b", "decode_32k", None,
                {"parallelism": "ddp_zero1"}))
    out.append(("vit-l16", "serve_b128", None, {"serve_pure_dp": True}))
    return out


def _same_shardings(spec, jspec):
    assert spec.name == jspec.name
    if jspec.fn is None:
        assert spec.in_shardings == jspec.in_shardings == ()
        assert spec.out_shardings is jspec.out_shardings is None
        return
    args = _port_leaves(spec.args)
    for got, want in ((spec.in_shardings, jspec.in_shardings),
                      (spec.out_shardings, jspec.out_shardings)):
        g, w = _port_leaves(got), jax.tree.leaves(want)
        assert len(g) == len(w), spec.name
        for a, b in zip(g, w):
            rank = len(b.spec) if b.spec else 0
            rank = max(rank, len(a))
            assert _norm(a, rank) == _norm(b.spec, rank), spec.name
    # in_shardings holds one spec per argument leaf
    assert len(_port_leaves(spec.in_shardings)) == len(args)


@pytest.mark.parametrize("arch,cell,variant,over", _cells(),
                         ids=lambda v: str(v))
def test_step_shardings_match_jax_256(arch, cell, variant, over):
    pm, jm = _meshes("16x16")
    spec = ST.build(arch, cell, variant=variant, cfg_overrides=over,
                    mesh=pm)
    jspec = JST.build(arch, cell, jm, variant=variant, cfg_overrides=over)
    _same_shardings(spec, jspec)


@pytest.mark.parametrize("arch", FAMILIES)
def test_step_shardings_match_jax_512(arch):
    pm, jm = _meshes("2x16x16")
    for name in get_shapes(arch):
        spec = ST.build(arch, name, mesh=pm)
        jspec = JST.build(arch, name, jm)
        _same_shardings(spec, jspec)


def test_unsharded_build_has_no_shardings():
    spec = ST.build("olmo-1b", "train_4k")
    assert spec.in_shardings is None and spec.out_shardings is None


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_shapes_match_jax(arch, jax_params):
    pm, jm = _meshes("2x2")
    p, st, scan = _port_params(arch)
    jp, jst = jax_params[arch]
    for tree, jtree in ((p, jp), (st, jst)):
        if tree is None:
            continue
        specs = _port_leaves(S.param_shardings(tree, pm, scan_layers=scan))
        jspecs = jax.tree.leaves(JS.param_shardings(jtree, jm,
                                                    scan_layers=scan))
        for t, s, js in zip(_port_leaves(tree), specs, jspecs):
            want = NamedSharding(jm, js.spec).shard_shape(tuple(t.shape))
            pl = S.to_placements(s, pm)
            for coord in ((0, 0), (0, 1), (1, 0), (1, 1)):
                got, _ = _compute_local_shape_and_global_offset(
                    tuple(t.shape), pm.axis_sizes, list(coord), pl)
                assert tuple(got) == want, (s, coord)


def test_placements_follow_the_spec():
    """``to_placements`` (on a stand-in mesh with the DeviceMesh's names)
    puts ``Shard(d)`` on each axis a dimension names, major to minor, and
    refuses an entry out of the mesh's order; an axis of size 1 is
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    class Names:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 2)

    m = Names()
    assert S.to_placements(S.P(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert S.to_placements(S.P(None, "data"), m) == (
        Replicate(), Shard(1), Replicate())
    assert S.to_placements(S.P(), m) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        S.to_placements(S.P(("data", "pod")), m)
    Names.shape = (1, 2, 1)
    assert S.to_placements(S.P(("pod", "data"), None, "model"), m) == (
        Replicate(), Shard(0), Replicate())


def test_constrain_without_a_device_mesh_is_a_no_op():
    x = torch.ones(2, 3)
    before = S.CONSTRAIN_MISSES
    assert S.constrain(x, None, "tokens") is x
    assert S.constrain(x, _meshes("2x2")[0], "tokens") is x
    assert S.CONSTRAIN_MISSES == before


def test_mesh_module_import_has_no_side_effects():
    import importlib
    importlib.reload(M)
    assert not dist.is_initialized()


def test_make_mesh_checks_its_shape_and_device():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 4 processes"):
        M.make_mesh((2, 2), ("data", "model"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_mesh((1, 1), ("data", "model"), device="cuda")
        with pytest.raises(ValueError, match="needs 256 devices, but 0"):
            M.make_production_mesh()
        with pytest.raises(ValueError, match="needs 512 devices, but 0"):
            M.make_production_mesh(multi_pod=True)
    mesh = M.make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        assert mesh.mesh_dim_names == ("data", "model")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        with pytest.raises(ValueError, match="has 1 ranks"):
            M.make_mesh((2, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
    assert np.prod(M.make_abstract_mesh((2, 16, 16), ("pod", "data",
                                                       "model")).axis_sizes) \
        == 512


@pytest.mark.parametrize("policy", ["dots", "dots_nobatch"])
@pytest.mark.parametrize("arch", ["olmo-1b", "moonshot-v1-16b-a3b"])
def test_remat_policies_see_the_same_products_on_dtensors(arch, policy,
                                                          monkeypatch):
    """Selective remat on a one-rank gloo mesh: the policy keeps the same
    products, in the same order, when the ops it sees carry DTensors,
    and ``loss_fn``'s loss and gradients are bitwise the plain model's
    (reduced fp32 configs)."""
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.common.config import reduced
    from repro_torch.models import layers as L

    real = L.remat_policy
    cfg = reduced(get_arch(arch), remat=True, remat_policy=policy,
                  dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))
    mesh = M.make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        runs = []
        for m in (None, mesh):
            kept = []

            def recording(name):
                policy_fn = real(name)

                def record(ctx, func, *a, **k):
                    d = policy_fn(ctx, func, *a, **k)
                    if d == CheckpointPolicy.MUST_SAVE:
                        kept.append(str(func))
                    return d
                return record
            monkeypatch.setattr(L, "remat_policy", recording)
            p, t = transformer.init(cfg, 0, "cpu"), toks
            if m is not None:
                p = S.distribute(p, S.param_shardings(p, m), m)
                t = S.distribute(toks, S.batch_spec(m), m)
            leaves = L.tree_leaves(p)
            for x in leaves:
                x.requires_grad_(True)
            loss, _ = transformer.loss_fn(p, t, t, cfg, mesh=m)
            grads = torch.autograd.grad(loss, leaves)
            runs.append((kept, S.full_tensor(loss),
                         S.full_tensor(list(grads))))
        (k0, l0, g0), (k1, l1, g1) = runs
        assert k0 and k0 == k1
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    finally:
        dist.destroy_process_group()
