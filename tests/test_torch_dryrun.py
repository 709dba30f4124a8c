"""The port's dry run (``repro_torch.launch.dryrun``) and its report,
held against the JAX package's ``repro.launch.dryrun``.

Every trace on a fake process group runs in ONE subprocess (this file as
a script): the group is global state of a process, and a pytest worker
must not hold one. The JAX side runs in a second subprocess, started at
the same time: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512
host devices, which must never happen in a pytest worker.

- ``model_flops`` equals JAX's for all 40 (arch, cell) pairs.
- The wire model gives ``tests/test_launch.py``'s
  ``test_collective_stats_parser`` numbers.
- F1 (ROADMAP C19): olmo-1b's train step with one attention head a model
  rank runs: a reduced config (d_model 256, 4 heads) on a (1, 4) mesh,
  and olmo-1b itself (one layer) on the (16, 16) mesh (the full sweep
  runs it on (2, 16, 16) too: 11 s of tracing, beyond this file's
  budget).
- F2 (C21): each kernel wrapper takes meta tensors and gives the plain
  version's shapes and dtypes, launching nothing; reduced moonshot's MoE
  prefill traces on a fake mesh (the router's ``topk`` on meta blocks),
  with the all-to-all NCCL would run.
- F3 (C22): reduced dit-s2's train and sampler steps trace with meta
  latents and a meta seed.
- C24 and C26: on reduced moonshot's train step on an (8, 2) mesh, the
  MoE experts' weights are gathered over "data" before their products
  at the hand-counted bytes, the products move nothing, and the
  experts' output moves by its all-to-all alone.
- On JAX's reduced 8-device cell (``tests/test_launch.py``: reduced
  olmo-1b, d_model 128, 4 heads, seq 128, batch 8, a (2, 2, 2) mesh) the
  port's per-device argument bytes are JAX's
  ``memory_analysis().argument_size_in_bytes``, but for the optimizer's
  step count (a Python int in the port, an int32 array in JAX).
- On a (2, 2) mesh that splits every dimension evenly, per-device FLOPs
  times the 4 ranks are the unsharded step's.
- The two-point extrapolation from 1 and 2 layers equals a direct trace
  at 4 layers.
- ``report.py`` renders its tables from hand-made records (and its
  one-row-per-cell table of both meshes).
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

# JAX's reduced 8-device cell (tests/test_launch.py)
CELL8 = {"d_model": 128, "n_heads": 4, "n_kv_heads": 2}
SEQ8, BATCH8 = 128, 8


# ---------------------------------------------------------------------------
# The port's side (this file as a script); no JAX here
# ---------------------------------------------------------------------------

def _reduced(arch, **over):
    from repro_torch.common.config import reduced
    from repro_torch.configs import get_arch
    return reduced(get_arch(arch), **over)


def _cell(arch, name, **over):
    from repro_torch.configs import get_shapes
    return dataclasses.replace(get_shapes(arch)[name], **over)


# C24's cell: reduced moonshot, one layer, one micro-batch (no remat),
# d_model 256 and d_ff 1024, 512 tokens: 16 groups of 32, capacity 20
C24_MESH = (8, 2)
C24_CELL = {"global_batch": 8, "seq_len": 64}


def _c24_cfg():
    return dataclasses.replace(_reduced("moonshot-v1-16b-a3b"), n_layers=1,
                               train_microbatches=1, d_model=256, d_ff=1024)


def _moe_line(text: str) -> int:
    """The line of ``layers.moe`` that holds ``text``."""
    import inspect
    from repro_torch.models import layers
    src, start = inspect.getsourcelines(layers.moe)
    return start + next(i for i, line in enumerate(src) if text in line)


# the lines of layers.moe that C24 and C26 read: the experts' output
# moved, the weights gathered, the products h, hg and the output (with
# the silu)
MOE_LINES = {"output": "exp_out = constrain(exp_out",
             "gather": "= (data_gathered(params[k])",
             "h": "h = torch.einsum(", "hg": "hg = torch.einsum(",
             "silu": "F.silu(hg) * h"}


def port_main():
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.hopper import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_fake_mesh, production_shape
    out = {}

    def measure(cfg, cell, mesh, variant=None):
        return D._measure(D._build(cfg, cell, variant, mesh), mesh)

    # F1: one head a model rank, reduced and at full width
    mesh = make_fake_mesh((1, 4), ("data", "model"))
    cfg = _reduced("olmo-1b", d_model=256, n_heads=4, n_kv_heads=4)
    out["f1_reduced"] = measure(cfg, _cell("olmo-1b", "train_4k",
                                           global_batch=4, seq_len=32),
                                mesh)["flops"]
    from repro_torch.configs import get_arch, get_shapes
    mesh = make_fake_mesh(*production_shape(False))
    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=1)
    out["f1_single"] = measure(cfg, get_shapes("olmo-1b")["train_4k"],
                               mesh)["flops"]

    # F2, F3: MoE and DiT steps on a (2, 2) fake mesh
    mesh = make_fake_mesh((2, 2), ("data", "model"))
    launches = dict(ops.LAUNCHES)
    cfg = _reduced("moonshot-v1-16b-a3b")
    rec = measure(cfg, _cell("moonshot-v1-16b-a3b", "prefill_32k",
                             global_batch=4, seq_len=64), mesh)
    out["moe_prefill"] = rec["coll"]["counts"]
    cfg = _reduced("dit-s2")
    for name in ("train_256", "gen_fast"):
        rec = measure(cfg, _cell("dit-s2", name, global_batch=4,
                                 img_res=cfg.img_res, steps=2), mesh)
        out[f"dit_{name}"] = rec["flops"]
    out["launches_unchanged"] = dict(ops.LAUNCHES) == launches

    # per-device FLOPs x ranks = unsharded, on an even (2, 2) mesh
    cfg = _reduced("olmo-1b")
    for name in ("train_4k", "prefill_32k"):
        cell = _cell("olmo-1b", name, global_batch=4, seq_len=64)
        out[f"even_{name}"] = [measure(cfg, cell, mesh)["flops"],
                               measure(cfg, cell, None)["flops"]]

    # two points at 1 and 2 layers against a direct trace at 4
    over = {k: getattr(cfg, k) for k in ("d_model", "n_heads", "n_kv_heads",
                                         "d_ff", "vocab_size")}
    est = D.estimate_costs("olmo-1b", "decode_32k", mesh,
                           cfg_overrides=dict(over, n_layers=4))
    direct = measure(dataclasses.replace(get_arch("olmo-1b"), n_layers=4,
                                         **over),
                     get_shapes("olmo-1b")["decode_32k"], mesh)
    out["extrap"] = {k: [est[k], direct[k]] for k in ("flops", "bytes",
                                                      "wire")}
    out["extrap_counts"] = [est["coll"]["counts"], direct["coll"]["counts"]]
    out["extrap_args"] = [est["memory"]["argument_size_in_bytes"],
                          direct["memory"]["argument_size_in_bytes"]]

    # C24 and C26: the MoE experts' weights and output on an (8, 2) mesh,
    # each line's collectives
    mesh = make_fake_mesh(C24_MESH, ("data", "model"))
    rec = measure(_c24_cfg(), _cell("moonshot-v1-16b-a3b", "train_4k",
                                    **C24_CELL), mesh)
    for name, text in MOE_LINES.items():
        site = f"models/layers.py:{_moe_line(text)}"
        out[f"moe_site/{name}"] = sorted(
            [kind, k, wire] for (at, kind, k), wire
            in rec["wire_by_site"].items() if at == site)

    # JAX's reduced 8-device cell
    mesh = make_fake_mesh((2, 2, 2), ("pod", "data", "model"))
    cfg = _reduced("olmo-1b", **CELL8)
    spec = D._build(cfg, _cell("olmo-1b", "train_4k", seq_len=SEQ8,
                               global_batch=BATCH8), None, mesh)
    out["cell8_args"] = sum(D._layout(spec, mesh)[1].values())
    dist.destroy_process_group()
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

_JAX = r"""
import dataclasses, json, sys
from repro.launch.dryrun import model_flops
import jax
from repro.common.config import LM_SHAPES, reduced
from repro.configs import ARCH_IDS, get_arch, get_shapes
import repro.launch.steps as st
from repro.launch.mesh import make_mesh
out = {"model_flops": {f"{a}:{c}": model_flops(a, cell)
                       for a in ARCH_IDS for c, cell in get_shapes(a).items()}}
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = dataclasses.replace(reduced(get_arch("olmo-1b")), **json.loads(
    sys.argv[1]))
cell = dataclasses.replace(LM_SHAPES["train_4k"], seq_len=int(sys.argv[2]),
                           global_batch=int(sys.argv[3]))
spec = st.build_lm(cfg, cell, mesh)
with mesh:
    compiled = jax.jit(spec.fn, in_shardings=spec.in_shardings,
                       out_shardings=spec.out_shardings,
                       donate_argnums=spec.donate_argnums
                       ).lower(*spec.args).compile()
out["cell8_args"] = int(compiled.memory_analysis().argument_size_in_bytes)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    """Starts the port's fake-group subprocess and the JAX subprocess
    together; returns (port's results, JAX's)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    jenv = dict(env, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True),
             subprocess.Popen([sys.executable, "-c", _JAX, json.dumps(CELL8),
                               str(SEQ8), str(BATCH8)],
                              env=jenv, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-4000:]
    return tuple(json.loads(o.strip().splitlines()[-1]) for o, _ in outs)


def test_model_flops_equal_jax(runs):
    from repro_torch.configs import ARCH_IDS, get_shapes
    from repro_torch.launch.dryrun import model_flops
    want = runs[1]["model_flops"]
    got = {f"{a}:{c}": model_flops(a, cell)
           for a in ARCH_IDS for c, cell in get_shapes(a).items()}
    assert len(got) == 40
    assert got == want


def test_wire_model_gives_the_parser_numbers():
    """``test_collective_stats_parser``'s three collectives: a bf16
    (16, 128) all-gather over 16 ranks, an f32 (64,) all-reduce over 4,
    an f32 (4,) reduce-scatter over 8; nothing for a group of one."""
    from repro_torch.launch.dryrun import collective_stats
    st = collective_stats([("all-gather", 16 * 128 * 2, tuple(range(16))),
                           ("all-reduce", 64 * 4, (0, 1, 2, 3)),
                           ("reduce-scatter", 4 * 4, tuple(range(8))),
                           ("all-gather", 8 * 4, (5,))])
    assert st["counts"]["all-gather"] == 2
    assert st["counts"]["all-reduce"] == 1
    assert st["counts"]["reduce-scatter"] == 1
    assert abs(st["wire_bytes"]["all-gather"] - 16 * 128 * 2 * 15 / 16) < 1
    assert abs(st["wire_bytes"]["all-reduce"] - 64 * 4 * 2 * 3 / 4) < 1
    assert abs(st["wire_bytes"]["reduce-scatter"] - 4 * 4 * 7) < 1
    # the 16-rank group crosses an 8-card node, the others stay inside
    assert st["cross_node_wire_bytes"] == st["wire_bytes"]["all-gather"]


def test_f1_train_step_with_one_head_a_rank(runs):
    port = runs[0]
    for key in ("f1_reduced", "f1_single"):
        assert port[key] > 0, key


def test_f2_moe_steps_trace_and_plan_all_to_all(runs):
    port = runs[0]
    assert port["moe_prefill"]["all-to-all"] > 0
    assert port["launches_unchanged"]


def _c24_groups():
    from repro_torch.models.layers import moe_groups
    cfg = _c24_cfg()
    n_tok = C24_CELL["global_batch"] * C24_CELL["seq_len"]
    gs, G, C = moe_groups(n_tok, cfg.moe_group_size, cfg.moe_top_k,
                          cfg.moe_capacity_factor, cfg.n_experts)
    assert (G, C) == (16, 20) and not cfg.remat
    return cfg, G, C


def test_c24_experts_output_is_a_reduce_scatter_then_an_all_to_all(runs):
    """ROADMAP C24 and C26: the experts' product, whole since its weights
    are gathered first (C26), is already in the "experts" layout (the
    experts over "model", the groups over "data"), and goes to
    "expert_groups" by the experts' all-to-all over "model" and nothing
    else: no reduce-scatter, no all-reduce at the site. Per device, the
    "experts" block is (E/2, G/8, C, D) bf16 and so is the
    "expert_groups" block (E, G/16, C, D); the ring model sends
    (k - 1)/k of one for an all-to-all over k ranks."""
    cfg, G, C = _c24_groups()
    data, model = C24_MESH
    block = (cfg.n_experts // model) * (G // data) * C * cfg.d_model * 2
    assert block == cfg.n_experts * (G // (data * model)) * C * \
        cfg.d_model * 2
    want = [["all-to-all", model, block * (model - 1) / model]]
    assert runs[0]["moe_site/output"] == want


def test_c26_experts_weights_are_gathered_before_their_products(runs):
    """ROADMAP C26: wi, wg and wo are gathered over "data" (FSDP's
    all-gather; the experts stay over "model") at one line, before the
    products, so that the products h and hg and the silu line contract
    nothing split and move nothing. Per device each gathered weight is
    (E/2, D, F) bf16 (wo (E/2, F, D)), of which the ring sends
    (k - 1)/k over the k data ranks: the three weights' all-gathers at
    the line are exactly that, once each (one micro-batch, no remat)."""
    cfg, _, _ = _c24_groups()
    data, model = C24_MESH
    weight = (cfg.n_experts // model) * cfg.d_model * cfg.d_ff * 2
    port = runs[0]
    for name in ("h", "hg", "silu"):
        assert port[f"moe_site/{name}"] == [], name
    assert port["moe_site/gather"] == [
        ["all-gather", data, 3 * weight * (data - 1) / data]]


def test_f3_dit_steps_trace_with_meta_latents(runs):
    port = runs[0]
    assert port["dit_train_256"] > 0 and port["dit_gen_fast"] > 0


def test_argument_bytes_equal_jax_on_the_8_device_cell(runs):
    """JAX's AdamW state holds its step count as an int32 array (4
    bytes, replicated); the port's is a Python int, no device bytes."""
    assert runs[0]["cell8_args"] + 4 == runs[1]["cell8_args"]


@pytest.mark.parametrize("name", ["train_4k", "prefill_32k"])
def test_even_mesh_flops_times_ranks_equal_unsharded(runs, name):
    per_dev, whole = runs[0][f"even_{name}"]
    assert per_dev * 4 == whole


def test_two_point_extrapolation_equals_direct_trace(runs):
    port = runs[0]
    for k, (est, direct) in port["extrap"].items():
        assert est == direct, k
    assert port["extrap_counts"][0] == port["extrap_counts"][1]
    assert port["extrap_args"][0] == port["extrap_args"][1]


# the kernel wrappers on meta tensors (F2): (wrapper, its plain version,
# the inputs' shapes and dtypes, extra arguments)
_F32 = torch.float32
_META = [
    ("centroid_assign", "centroid_assign_ref",
     [((8, 16), _F32), ((5, 16), _F32)], (0.5,)),
    ("centroid_assign_stacked", "centroid_assign_stacked_ref",
     [((3, 8, 16), _F32), ((3, 5, 16), _F32)], (0.5,)),
    ("pixel_match", "pixel_match_ref",
     [((6, 12), _F32), ((9, 12), _F32)], (0.1,)),
    ("pixel_match_ranges", "pixel_match_ranges_ref",
     [((6, 12), _F32), ((9, 12), _F32), ((6,), torch.int32),
      ((6,), torch.int32)], (0.1,)),
    ("dequant_topk", "dequant_topk_ref",
     [((7, 20), torch.int8), ((7,), _F32)], (4,)),
    ("topk", "topk_ref", [((7, 20), _F32)], (3,)),
    ("motion_gate_frames", "motion_gate_frames_ref",
     [((2, 16, 24, 3), _F32), ((16, 24, 3), _F32)], (0.1, 0.2)),
    ("motion_gate", "motion_gate_ref",
     [((16, 24, 3), _F32), ((16, 24, 3), _F32)], (0.1, 0.2)),
    ("flash_attention", "flash_attention_ref",
     [((2, 8, 4, 16), _F32)] * 3, ()),
]


@pytest.mark.parametrize("case", _META, ids=[c[0] for c in _META])
def test_wrappers_take_meta_tensors(case):
    """Each wrapper on meta inputs: the plain version's output shapes
    and dtypes (on CPU inputs of those shapes), no launch counted."""
    from repro_torch.hopper import ops, ref
    name, ref_name, shapes, extra = case
    cpu = [torch.ones(s, dtype=d) if d.is_floating_point
           else torch.zeros(s, dtype=d) for s, d in shapes]
    if name == "pixel_match_ranges":
        cpu[3] = torch.full((6,), 9, dtype=torch.int32)
    meta = [t.to("meta") for t in cpu]
    before = dict(ops.LAUNCHES)
    got = getattr(ops, name)(*meta, *extra)
    assert dict(ops.LAUNCHES) == before
    # the motion gate's plain versions take the tile explicitly
    tile = (8,) if name.startswith("motion_gate") else ()
    want = getattr(ref, ref_name)(*cpu, *extra, *tile)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)


@pytest.mark.parametrize("groups", [1, 8])
def test_conv_backward_counts_the_forward_twice(groups):
    """A convolution's backward (input and weight gradients) counts twice
    its forward's FLOPs, grouped (depthwise) or not."""
    from repro_torch.launch.dryrun import _Counter
    x = torch.empty((2, 8, 12, 12), device="meta", requires_grad=True)
    w = torch.empty((8, 8 // groups, 3, 3), device="meta",
                    requires_grad=True)
    with _Counter() as fwd:
        y = torch.nn.functional.conv2d(x, w, padding=1, groups=groups)
    with _Counter() as bwd:
        torch.autograd.grad(y.sum(), (x, w))
    assert fwd.flops == 2 * 2 * 8 * 12 * 12 * (8 // groups) * 9
    assert bwd.flops == 2 * fwd.flops


def test_memory_peak_of_a_hand_counted_step():
    """``_measure``'s temporaries on a step whose storages are counted by
    hand: the argument is not counted, a view or an in-place op adds no
    storage, a freed one leaves the live count, and the peak (12288
    bytes) less the 4-byte output is ``temp_size_in_bytes``."""
    from types import SimpleNamespace
    from repro_torch.launch.dryrun import _measure

    def fn(x):
        a = x * 2                   # live 4096
        b = a + 1                   # 8192
        del a                       # 4096
        c = torch.cat([b, b])       # 12288, the peak: add 4096, cat 8192
        del b                       # 8192
        c.view(2, 1024).mul_(3)     # no new storage
        return c.sum()              # 8196, the output 4

    x = torch.empty(1024, device="meta")
    rec = _measure(SimpleNamespace(fn=fn, args=(x,), in_shardings=None),
                   None)
    assert rec["memory"] == {"argument_size_in_bytes": 4096,
                             "output_size_in_bytes": 4,
                             "temp_size_in_bytes": 12284,
                             "alias_size_in_bytes": 0}
    assert rec["peak_by_op"] == {"add": 4096, "cat": 8192}


def test_wrapper_checks_run_on_meta():
    """The kernel path's argument checks hold for meta tensors too."""
    from repro_torch.hopper import ops
    with pytest.raises(ValueError, match="float32"):
        ops.topk(torch.empty((4, 8), dtype=torch.float64, device="meta"), 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.pixel_match(torch.empty((4, 6), device="meta"),
                        torch.empty((3, 6), device="meta"), 0.1)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(*[torch.empty((1, 4, 2, 24), device="meta")] * 3)


def _rec(arch, cell, mesh, **kw):
    shape = {"data": 16, "model": 16} if mesh == "single" else \
        {"pod": 2, "data": 16, "model": 16}
    rec = {"arch": arch, "cell": cell, "variant": None, "mesh": shape,
           "ok": True}
    rec.update(kw)
    return rec


def test_report_tables_from_records(tmp_path):
    from repro_torch.launch import report
    recs = [
        _rec("olmo-1b", "train_4k", "single", compile_s=1.5,
             memory={"live_bytes_per_device": 12.5e9, "fits_80gb_hbm": True},
             scanned_raw={"collective_counts": {
                 "all-gather": 3, "all-reduce": 1, "reduce-scatter": 2,
                 "all-to-all": 0, "collective-permute": 0}},
             roofline={"compute_s": 0.5, "memory_s": 0.002,
                       "collective_s": 1.25, "dominant": "collective_s",
                       "bound_step_s": 1.25},
             model_flops=7.4e15, useful_flops_ratio=0.65,
             roofline_fraction=0.024),
        _rec("dbrx-132b", "train_4k", "multi", compile_s=3.0,
             memory={"live_bytes_per_device": 114.7e9,
                     "fits_80gb_hbm": False},
             scanned_raw={"collective_counts": {"all-to-all": 4}},
             roofline={"compute_s": 1.0, "memory_s": 2.0,
                       "collective_s": 3.0, "dominant": "collective_s",
                       "bound_step_s": 3.0},
             model_flops=1e16, useful_flops_ratio=0.5,
             roofline_fraction=0.01),
        _rec("olmo-1b", "long_500k", "single", skipped=True,
             skip_reason="pure full-attention arch"),
        _rec("vit-s16", "cls_224", "single", ok=False, error="boom"),
    ]
    for i, r in enumerate(recs):
        with open(tmp_path / f"r{i}_{'multi' if 'pod' in r['mesh'] else 'single'}.json",
                  "w") as f:
            json.dump(r, f)
    loaded = report.load(str(tmp_path))
    assert [r["mesh_tag"] for r in loaded] == ["single", "multi", "single",
                                               "single"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.dryrun_table(loaded)
        report.roofline_table(loaded)
        report.cell_table(loaded)
    text = buf.getvalue().splitlines()
    # both meshes of a cell on one row
    assert "| dbrx-132b | train_4k | — | collective, 3.00s, 0.010, 114.7, " \
           "**NO** |" in text
    assert "| olmo-1b | long_500k | skip (full attention) | — |" in text
    assert "| olmo-1b | train_4k | single | ok | 1.5s | 12.5 | yes | " \
           "3/1/2/0/0 |" in text
    assert "| dbrx-132b | train_4k | multi | ok | 3.0s | 114.7 | **NO** | " \
           "0/0/0/4/0 |" in text
    assert any("SKIP" in t and "long_500k" in t for t in text)
    assert any("**FAIL**: boom" in t for t in text)
    assert "| olmo-1b | train_4k | 500.0ms | 2.0ms | 1.25s | " \
           "**collective** | 1.25s | 7.4e+15 | 0.65 | 0.024 |" in text
    # the roofline table holds the single-pod records that ran
    roof = text.index("| arch | cell | compute | memory | collective | "
                      "dominant | bound/step | MODEL_FLOPS | useful ratio | "
                      "roofline frac |")
    cells = text.index("| arch | cell | 16x16: dominant, bound, frac, "
                       "GB/dev, fits | 2x16x16: dominant, bound, frac, "
                       "GB/dev, fits |")
    assert [t.split(" | ")[0] for t in text[roof + 2:cells]] == ["| olmo-1b"]


if __name__ == "__main__":
    port_main()
