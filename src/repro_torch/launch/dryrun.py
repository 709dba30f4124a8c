"""Multi-pod dry run: trace every (arch x input shape x mesh) step on the
production meshes, per device, without the devices. A port of
``repro.launch.dryrun``.

JAX lowers and compiles each step for 512 placeholder devices (its
module's first two lines force them). The port traces each step eagerly
on meta tensors (shapes and dtypes, no storage) over a fake process
group of 256 or 512 ranks, this process being rank 0
(``launch.mesh.make_fake_mesh``): a CUDA-typed ``DeviceMesh``, so
DTensor plans the collectives NCCL would run, all-to-all included. No
card is needed and no collective moves data. Importing this module
starts no group; ``run_cell`` does, and restarts it when the mesh's size
changes.

Per cell the record holds, as JAX's does: whether the step ran, its
memory per device (``memory``), its FLOPs, bytes and collectives, and
the three roofline terms. Everything is counted on rank 0's local ops,
per device (``_Counter``):

- FLOPs: the local matrix products and convolutions
  (``torch.utils.flop_counter``'s formulas; a convolution's backward by
  ``_conv_backward_flops``, which counts grouped convolutions right).
- Bytes: over the local ops, each input's and output's bytes. The step
  runs eagerly and unfused, so this bounds XLA's "bytes accessed" from
  above (``method`` says so).
- Collectives: each ``_c10d_functional`` op's kind (and DTensor's
  ``_dtensor.shard_dim_alltoall``), result bytes R and group size k,
  through ``collective_stats``' ring model.
- Memory: rank 0's argument and output shards, and the peak of the
  storages the step holds live besides its arguments (the largest block
  of an uneven split is rank 0's).

``scanned_raw`` also says where the one-layer trace's bytes sit: the
temporaries live at its peak by the op and the model line that made
them (``peak_live_by_op``), and its wire bytes by the line, kind and
group size that sent them (``wire_by_site``). These depend on DTensor's
plans, so on torch's version.

Depth: the step is traced at 1 and 2 layers and its costs extrapolated
to the config's depth, as ``estimate_costs`` does in JAX (EfficientNet is
traced whole). The port's train step runs its micro-batches one after
another, so the counts hold them already: nothing is scaled by
``train_microbatches``. DiT's sampler is traced at one step and scaled
by the cell's steps.

Roofline constants: the H100 SXM data sheet's dense bf16 rate and HBM
rate; NVLink 4's 450 GB/s per direction for a group inside one 8-card
node; for a group across nodes, one 400 Gb/s NDR InfiniBand port per
card (50 GB/s), as the DGX H100 reference design wires it. These model
a cluster; they are not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch all --shape all --mesh both --out experiments/torch_dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.common.config import DiTConfig, LMConfig, ShapeCell, ViTConfig
from repro_torch.configs import ARCH_IDS, get_arch, get_shapes

# --- modelled cluster constants (H100 SXM data sheet, DGX H100 network) ----
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card and direction, inside a node
NET_BW = 50e9                # bytes/s per card across nodes (400 Gb/s NDR)
NODE_CARDS = 8               # cards that share one NVLink domain
HBM_BYTES = 80e9             # H100 80GB

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# collective op names (``_c10d_functional`` and DTensor's own
# ``_dtensor`` ops) -> JAX's collective kinds
_C10D_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",     # DTensor's Shard(i) -> Shard(j)
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor", "c10d")
# bookkeeping of the functional collectives: no data moves
_C10D_QUIET = {"wait_tensor", "_wrap_tensor_autograd"}
# allocate without writing: no bytes accessed
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided"}

METHOD = ("eager trace on meta tensors, rank 0's local ops; bytes = inputs "
          "+ outputs of every unfused op (an upper bound on fused "
          "traffic)")


def wire_factor(kind: str, k: int) -> float:
    """Per-device wire bytes per result byte, ring algorithm, group of k:
    all-gather (k-1)/k, all-reduce 2(k-1)/k, reduce-scatter k-1,
    all-to-all (k-1)/k, permute 1."""
    if k <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (k - 1) / k
    if kind == "reduce-scatter":
        return float(k - 1)
    if kind == "collective-permute":
        return 1.0
    return (k - 1) / k


def collective_stats(ops) -> dict:
    """Per-device wire bytes by collective kind from ``(kind, result
    bytes R, group ranks)`` triples, JAX's ``collective_stats`` model:

      all-gather: R(k-1)/k   all-reduce: 2R(k-1)/k
      reduce-scatter: R(k-1) all-to-all: R(k-1)/k  permute: R

    A group inside one ``NODE_CARDS``-card node runs at ``NVLINK_BW``,
    one across nodes at ``NET_BW``: ``wire_s`` is the sum of each op's
    bytes over its rate."""
    out = dict.fromkeys(KINDS, 0.0)
    counts = dict.fromkeys(KINDS, 0)
    cross = 0.0
    wire_s = 0.0
    for kind, r, ranks in ops:
        w = r * wire_factor(kind, len(ranks))
        inside = len({x // NODE_CARDS for x in ranks}) <= 1
        out[kind] += w
        counts[kind] += 1
        if not inside:
            cross += w
        wire_s += w / (NVLINK_BW if inside else NET_BW)
    return {"wire_bytes": out, "counts": counts,
            "total_wire_bytes": sum(out.values()),
            "cross_node_wire_bytes": cross, "wire_s": wire_s}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _conv_backward_flops(grad_out, x, w, bias_sizes, stride, padding,
                         dilation, transposed, output_padding, groups,
                         output_mask) -> int:
    """A convolution's backward: each gradient asked for (input, weight)
    costs the forward's 2·MACs. torch's formula counts the weight
    gradient of a grouped convolution as a dense one (C_in times too
    much for a depthwise convolution)."""
    per = 2 * math.prod(w.shape[1:])          # MACs of one output element
    fwd = per * math.prod((x if transposed else grad_out).shape)
    return fwd * sum(bool(m) for m in output_mask[:2])


def _group_ranks(name: str) -> tuple:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))


def _site() -> str:
    """The model line that issued an op: the innermost frame of
    ``repro_torch`` outside the sharding helpers and this module (for a
    backward op, the line that called autograd), else ``""``."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename.replace(os.sep, "/")
        if "/repro_torch/" in path and not path.endswith(
                ("/distributed/sharding.py", "/launch/dryrun.py")):
            return f"{path.rsplit('/repro_torch/', 1)[1]}:{f.f_lineno}"
        f = f.f_back
    return ""


def _top(d: dict, n: int = 8) -> list:
    """The n largest entries of {key: number}, largest first."""
    return sorted(d.items(), key=lambda kv: -kv[1])[:n]


class _Counter(TorchDispatchMode):
    """Counts rank 0's local ops: matmul/conv FLOPs, bytes in and out,
    the functional collectives, and the storages live beyond the
    arguments' (``arg_storages``) on the device, at their peak.

    A DTensor op is let through (``NotImplemented``): DTensor then runs
    the local ops, which reach this mode as plain tensors. The ops DTensor
    runs on fake tensors to propagate global shapes (with the fake mode
    active) are not rank 0's and are skipped."""

    def __init__(self, arg_storages=()):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._flops = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = []
        self.args = set(arg_storages)
        self.live = 0
        self.peak = 0
        self._sizes = {}                # storage key -> (bytes, op)
        self._live_by_op = {}
        self.peak_by_op = {}            # "op@site" -> bytes live at the peak
        self.wire_by_site = {}          # (site, kind, k) -> wire bytes

    def _free(self, key):
        n, op = self._sizes.pop(key, (0, None))
        self.live -= n
        if op is not None:
            self._live_by_op[op] -= n

    def _track(self, out, op):
        for t in _tensors(out):
            if t.device.type != "meta":
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.args or key in self._sizes:
                continue
            n = st.nbytes()
            self._sizes[key] = (n, op)
            self.live += n
            self._live_by_op[op] = self._live_by_op.get(op, 0) + n
            weakref.finalize(st, self._free, key)
        if self.live > self.peak:
            self.peak = self.live
            self.peak_by_op = {k: v for k, v in self._live_by_op.items()
                               if v}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out
        name = func.overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if name in _C10D_QUIET:
                return out
            if name not in _C10D_KINDS:
                raise NotImplementedError(f"collective {func} has no wire "
                                          f"model")
            group = args[-1] if isinstance(args[-1], str) \
                else kwargs["group_name"]
            op = (_C10D_KINDS[name], sum(_bytes(t) for t in _tensors(out)),
                  _group_ranks(group))
            self.coll.append(op)
            site = (_site(), op[0], len(op[2]))
            self.wire_by_site[site] = (self.wire_by_site.get(site, 0.0)
                                       + op[1] * wire_factor(op[0],
                                                             len(op[2])))
        elif func is torch.ops.aten.convolution_backward.default:
            self.flops += _conv_backward_flops(*args)
        elif func.overloadpacket in self._flops:
            self.flops += self._flops[func.overloadpacket](
                *args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(_bytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_bytes(t) for t in _tensors(out))
        if any(t.device.type == "meta" for t in _tensors(out)):
            site = _site()
            self._track(out, f"{name}@{site}" if site else name)
        return out


def _local_storages(tree) -> dict:
    """{storage key: bytes} of the local blocks of a tree's tensors."""
    from repro_torch.distributed.sharding import is_dtensor
    out = {}
    for t in _tensors(tree):
        loc = t.to_local() if is_dtensor(t) else t
        out[loc.untyped_storage()._cdata] = _bytes(loc)
    return out


def _layout(spec, mesh):
    """A StepSpec's arguments laid out on the mesh by its in_shardings,
    and {storage key: bytes} of rank 0's blocks of them."""
    from repro_torch.distributed.sharding import distribute
    args = distribute(spec.args, spec.in_shardings, mesh)
    return args, _local_storages(args)


def _measure(spec, mesh) -> dict:
    """Trace a StepSpec once on the fake mesh and read rank 0's FLOPs,
    bytes, collectives and memory."""
    args, arg_st = _layout(spec, mesh)
    with _Counter(arg_st) as c:
        out = spec.fn(*args)
    out_st = _local_storages(out)
    coll = collective_stats(c.coll)
    alias = sum(b for k, b in out_st.items() if k in arg_st)
    arg_b, out_b = sum(arg_st.values()), sum(out_st.values())
    return {"flops": float(c.flops), "bytes": float(c.bytes),
            "wire": coll["total_wire_bytes"], "coll": coll,
            "memory": {"argument_size_in_bytes": arg_b,
                       "output_size_in_bytes": out_b,
                       # what the step held live besides its arguments, the
                       # outputs it made excepted
                       "temp_size_in_bytes": max(
                           c.peak - (out_b - alias), 0),
                       "alias_size_in_bytes": alias},
            "peak_by_op": c.peak_by_op, "wire_by_site": c.wire_by_site}


def _build(cfg, cell: ShapeCell, variant, mesh):
    """``steps.build``'s dispatch on a config and cell of our own."""
    from repro_torch.common.config import EffNetConfig
    from repro_torch.launch import steps as st
    if isinstance(cfg, LMConfig):
        if cell.kind == "long" and variant == "window":
            return st.build_lm_long_window(cfg, cell, mesh)
        return st.build_lm(cfg, cell, mesh)
    if isinstance(cfg, DiTConfig):
        return st.build_dit(cfg, cell, mesh)
    if isinstance(cfg, ViTConfig):
        return st.build_vit(cfg, cell, mesh)
    if isinstance(cfg, EffNetConfig):
        return st.build_effnet(cfg, cell, mesh)
    raise TypeError(type(cfg))


def _config(arch_id: str, cfg_overrides=None):
    cfg = get_arch(arch_id)
    return dataclasses.replace(cfg, **cfg_overrides) if cfg_overrides \
        else cfg


def _extrap(a, b, L: int):
    """F(L) = F(1) + (L-1)·max(F(2)-F(1), 0), leaf for leaf of two equal
    trees of numbers."""
    if isinstance(a, dict):
        return {k: _extrap(a[k], b[k], L) for k in a}
    return a + (L - 1) * max(b - a, 0)


def estimate_costs(arch_id: str, cell_name: str, mesh, variant=None,
                   cfg_overrides=None):
    """Per-device costs at the config's depth from traces at 1 and 2
    layers, extrapolated linearly: F(L) = F(1) + (L-1)·(F(2)-F(1)); the
    intercept holds the embeddings, the head and the optimizer's outer
    work, the slope a layer's. Memory is extrapolated the same way.
    DiT's gen cells are traced with the sampler at one step and scaled by
    the cell's steps (memory is not: the steps run one after another).
    ``raw`` is the one-layer trace. EfficientNet (no layer stack) is
    traced whole."""
    cfg = _config(arch_id, cfg_overrides)
    cell = get_shapes(arch_id)[cell_name]
    if not hasattr(cfg, "n_layers"):
        rec = _measure(_build(cfg, cell, variant, mesh), mesh)
        return dict(rec, method="direct: " + METHOD, raw=rec)
    steps = cell.steps if isinstance(cfg, DiTConfig) \
        and cell.kind == "dit_gen" else 1
    vcell = dataclasses.replace(cell, steps=1) if steps > 1 else cell
    recs = [_measure(_build(dataclasses.replace(cfg, n_layers=L), vcell,
                            variant, mesh), mesh) for L in (1, 2)]
    L = cfg.n_layers
    keep = ("flops", "bytes", "wire")
    out = {k: _extrap(recs[0][k], recs[1][k], L) * steps for k in keep}
    coll = _extrap({k: recs[0]["coll"][k] for k in
                    ("wire_bytes", "counts", "cross_node_wire_bytes",
                     "wire_s")},
                   {k: recs[1]["coll"][k] for k in
                    ("wire_bytes", "counts", "cross_node_wire_bytes",
                     "wire_s")}, L)
    coll = {"wire_bytes": {k: v * steps for k, v in
                           coll["wire_bytes"].items()},
            "counts": {k: v * steps for k, v in coll["counts"].items()},
            "cross_node_wire_bytes": coll["cross_node_wire_bytes"] * steps,
            "wire_s": coll["wire_s"] * steps}
    coll["total_wire_bytes"] = out["wire"]
    out["coll"] = coll
    out["memory"] = _extrap(recs[0]["memory"], recs[1]["memory"], L)
    out["method"] = "2pt-extrapolation (1, 2 layers): " + METHOD
    out["raw"] = recs[0]
    return out


def model_flops(arch_id: str, cell: ShapeCell) -> float:
    """Reference useful work: 6·N·D train / 2·N·D inference (N = active)."""
    cfg = get_arch(arch_id)
    n = cfg.n_active_params()
    if isinstance(cfg, LMConfig):
        tokens = cell.global_batch * max(cell.seq_len, 1)
        if cell.kind == "train":
            return 6.0 * n * tokens
        if cell.kind == "prefill":
            return 2.0 * n * tokens
        return 2.0 * n * cell.global_batch          # decode: 1 new token
    if isinstance(cfg, DiTConfig):
        toks = cell.global_batch * cfg.n_tokens(cell.img_res)
        if cell.kind == "dit_train":
            return 6.0 * n * toks
        return 2.0 * n * toks * cell.steps
    # vision
    if isinstance(cfg, ViTConfig):
        fwd = 2.0 * n * cell.global_batch * cfg.n_tokens(cell.img_res)
    else:
        from repro_torch.models.efficientnet import flops_per_image
        fwd = float(flops_per_image(cfg, cell.img_res)) * cell.global_batch
    return 3.0 * fwd if cell.kind == "cls" else fwd


def run_cell(arch_id: str, cell_name: str, multi_pod: bool,
             variant=None, cfg_overrides=None) -> dict:
    """Trace one cell on the (16, 16) or (2, 16, 16) fake mesh and return
    its record (JAX's keys; ``fits_80gb_hbm`` for ``fits_16gb_hbm``)."""
    from repro_torch.launch.mesh import make_fake_mesh, production_shape
    mesh = make_fake_mesh(*production_shape(multi_pod))
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_chips = math.prod(mesh.shape)
    cell = get_shapes(arch_id)[cell_name]
    rec = {"arch": arch_id, "cell": cell_name, "variant": variant,
           "overrides": cfg_overrides, "mesh": shape, "n_chips": n_chips,
           "ok": False}

    t0 = time.time()
    spec = _build(_config(arch_id, cfg_overrides), cell, variant, mesh)
    if spec.skip_reason:
        rec.update(skipped=True, skip_reason=spec.skip_reason, ok=True)
        return rec
    t_lower = time.time() - t0
    est = estimate_costs(arch_id, cell_name, mesh, variant=variant,
                         cfg_overrides=cfg_overrides)
    t_compile = time.time() - t0 - t_lower

    mem = dict(est["memory"])
    live = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    mem["live_bytes_per_device"] = live
    mem["fits_80gb_hbm"] = bool(live < HBM_BYTES)

    raw = est["raw"]
    rec["scanned_raw"] = {          # the one-layer trace, as counted
        "flops": raw["flops"], "bytes": raw["bytes"],
        "wire_bytes": raw["wire"],
        "collective_counts": raw["coll"]["counts"],
        # where the one-layer trace's bytes sit: the temporaries live at
        # its peak by the op and line that made them, and its wire bytes
        # by the line, kind and group size that sent them
        "peak_live_by_op": dict(_top(raw["peak_by_op"])),
        "wire_by_site": [{"site": k[0], "kind": k[1], "group": k[2],
                          "wire_bytes": v}
                         for k, v in _top(raw["wire_by_site"])]}
    flops_dev, bytes_dev = est["flops"], est["bytes"]
    coll = est["coll"]
    coll = {"wire_bytes": coll["wire_bytes"], "counts": coll["counts"],
            "total_wire_bytes": coll["total_wire_bytes"],
            "cross_node_wire_bytes": coll["cross_node_wire_bytes"],
            "method": est["method"]}

    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = est["coll"]["wire_s"]
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)

    mf = model_flops(arch_id, cell)
    hlo_total_flops = flops_dev * n_chips
    rec.update(
        ok=True, lower_s=round(t_lower, 2), compile_s=round(t_compile, 2),
        memory=mem,
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        collectives=coll,
        roofline={**terms, "dominant": dominant,
                  "bound_step_s": max(terms.values())},
        model_flops=mf, hlo_total_flops=hlo_total_flops,
        useful_flops_ratio=(mf / hlo_total_flops if hlo_total_flops else 0.0),
        roofline_fraction=(
            (mf / n_chips / PEAK_FLOPS) / max(terms.values())
            if max(terms.values()) > 0 else 0.0),
        constants={"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                   "nvlink_bw": NVLINK_BW, "net_bw": NET_BW,
                   "node_cards": NODE_CARDS, "hbm_bytes": HBM_BYTES,
                   "source": "H100 SXM data sheet (modelled, not "
                             "measured)"},
    )
    return rec


def summary(rec: dict) -> str:
    """One line of a record, as ``main`` prints it."""
    if rec.get("skipped"):
        return f"  skipped: {rec['skip_reason'][:60]}"
    if not rec.get("ok"):
        return f"  FAILED: {rec.get('error')}"
    r, m = rec["roofline"], rec["memory"]
    return (f"  ok trace={rec['compile_s']}s "
            f"flops/dev={rec['flops_per_device']:.3g} "
            f"GB/dev={m['live_bytes_per_device'] / 1e9:.1f} "
            f"dom={r['dominant']} "
            f"roofline_frac={rec['roofline_fraction']:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--variant", default=None)
    ap.add_argument("--out", default="experiments/torch_dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    n_fail = 0
    t_all = time.time()
    # mesh-major: the fake group restarts once per mesh size
    for mp in meshes:
        tag = "multi" if mp else "single"
        for arch in archs:
            shapes = (list(get_shapes(arch)) if args.shape == "all"
                      else args.shape.split(","))
            for cell in shapes:
                suffix = f"_{args.variant}" if args.variant else ""
                path = os.path.join(args.out,
                                    f"{arch}_{cell}_{tag}{suffix}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {path}")
                    continue
                print(f"[dryrun] {arch} x {cell} x {tag} ...", flush=True)
                try:
                    rec = run_cell(arch, cell, mp, variant=args.variant)
                except Exception as e:
                    rec = {"arch": arch, "cell": cell,
                           "variant": args.variant, "mesh_tag": tag,
                           "ok": False, "error": str(e),
                           "traceback": traceback.format_exc()}
                    n_fail += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(summary(rec), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"done, failures={n_fail}, seconds={time.time() - t_all:.1f}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
