#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: the quickest proof that the port builds, is right, and serves on
the card.

  python3 chip_smoke.py                 # from the root of a checkout

Phases, each fatal on failure (no phase's failure is caught):

1. the card (``nvidia-smi``), torch/CUDA versions, and the build of the
   three Hopper kernels from ``src/repro_torch/hopper/csrc``;
2. every kernel against its plain PyTorch version on the card, at the
   main path's shapes plus ragged, tie, dead-slot, threshold-edge and
   empty cases, with its time, the plain version's, one PyTorch library
   call's (a yardstick only; the port never calls it) and its bound;
3. the two served paths of ``repro_torch.launch.serve`` on the busiest
   stream (jacksonh, 600 s at 30 fps) with the full-width cheap1 CNN from
   seeded random weights, 4 tenants, 3 rounds: the one-shot ingest, then
   the archive (``--archive`` into a temporary directory, 2048 objects
   per shard, 8 chunks with tenants querying between them). Each path's
   launch counters are zeroed just before it and read just after: the
   one-shot path must launch ``centroid_assign`` and ``pixel_match``, the
   archive path all three kernels. ``dequant_topk`` is then timed on the
   largest sealed shard's own quantized rows;
4. card against CPU on a 60 s cut of the stream: the same CNN outputs
   ingested on ``cuda`` and on ``cpu`` save byte-identical indexes and
   answer identically, a 5-chunk ingest on the card saves the same bytes
   as one-shot, and the CNN's outputs agree to atol 1e-4; likewise for
   the archive: card-chunked, card one-shot and CPU shards byte-identical,
   and lazy (kernel-ranked) answers equal eagerly loaded shards' and the
   CPU's;
5. where the ingest time goes: wall time per stage on a 120 s cut.

Earlier lines are JSON objects, one per line; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a card, or when
run anywhere but the root of a checkout. Tolerances: indices, ``matched``
and match decisions exact; squared distances rtol 1e-5 (fp32 dot products
summed in another order; atol 1e-4 where a distance cancels to ~0); mean
pixel differences rtol 1e-6; ``dequant_topk`` values and indices exact.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
LIMIT_S = 1200
T_START = time.perf_counter()

# Published peaks (NVIDIA data sheets, dense, without sparsity) by the
# variant nvidia-smi names: fp32 and fp64 outside the tensor cores, and
# device-memory bandwidth.
PEAKS = {
    "PCIe": {"fp32": 51.2e12, "fp64": 25.6e12, "bytes": 2.0e12},
    "NVL": {"fp32": 60.0e12, "fp64": 30.0e12, "bytes": 3.9e12},
    "SXM": {"fp32": 67.0e12, "fp64": 34.0e12, "bytes": 3.35e12},
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def elapsed():
    return time.perf_counter() - T_START


def peaks_for(name: str) -> dict:
    for key in ("PCIe", "NVL"):
        if key in name:
            return dict(PEAKS[key], variant=key)
    return dict(PEAKS["SXM"], variant="SXM")


def time_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _assign_pair(ops, ref, f, c, T):
    import numpy as np
    import torch
    got = ops.centroid_assign(f, c, threshold=T)
    want = ref.centroid_assign_ref(f, c, T)
    torch.cuda.synchronize()
    d2, j, m = (x.cpu().numpy() for x in got)
    d2r, jr, mr = (x.cpu().numpy() for x in want)
    check((j == jr).all(), f"centroid_assign argmin differs at "
          f"{np.nonzero(j != jr)[0][:5].tolist()}")
    check((m == mr).all(), "centroid_assign matched differs")
    np.testing.assert_allclose(d2, d2r, rtol=1e-5, atol=1e-4)
    return float(np.abs(d2 - d2r).max()) if len(d2) else 0.0, j, m


def check_centroid_assign(ops, ref, dev):
    import numpy as np
    import torch
    r = np.random.default_rng(0)
    errs = []

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    # the path's shape: B=512 features against M=4096 slots, the upper
    # half exact duplicates of the lower (every argmin has a tied partner
    # and must take the lower index), slots >= n=3000 dead at 1e9
    B, M, D = 512, 4096, 128
    c = r.normal(size=(M, D)).astype(np.float32)
    c[M // 2:] = c[:M // 2]
    f = r.normal(size=(B, D)).astype(np.float32)
    nearest = torch.cdist(t(f), t(c[:M // 2])).min(1).values
    T = float(nearest.median())       # a threshold that splits the batch
    err, j, m = _assign_pair(ops, ref, t(f), t(c), T)
    errs.append(err)
    check((j < M // 2).all() and 0 < m.sum() < B, "ties / threshold unused")
    dead = c.copy()
    dead[3000:] = 1e9
    errs.append(_assign_pair(ops, ref, t(f), t(dead), T)[0])
    # ragged M edge, masked in the kernel
    errs.append(_assign_pair(ops, ref, t(r.normal(size=(37, D))),
                             t(r.normal(size=(1000, D))), 15.5)[0])
    # n = 0: every slot dead -> all scores tie, index 0, nothing matched
    _, j, m = _assign_pair(ops, ref, t(f[:37]), t(np.full((M, D), 1e9)), T)
    check((j == 0).all() and not m.any(), "n = 0 must give index 0")
    # d2 == fp32(0.8)**2 exactly is matched; one ulp more is not
    fe = np.zeros((2, D), np.float32)
    fe[0, 0] = np.float32(0.8)
    fe[1, 0] = np.nextafter(np.float32(0.8), np.float32(1))
    _, j, m = _assign_pair(ops, ref, t(fe), t(np.zeros((8, D))), 0.8)
    check(m.tolist() == [True, False], "fp32 T^2 edge")
    return max(errs), (t(f), t(dead), T)


def _match_pair(ops, ref, a, b, thr):
    import numpy as np
    import torch
    m, d = ops.pixel_match(a, b, thr)
    mr, dr = ref.pixel_match_ref(a, b, thr)
    torch.cuda.synchronize()
    m, d, mr, dr = (x.cpu().numpy() for x in (m, d, mr, dr))
    check((m == mr).all(), f"pixel_match differs: {m[:8]} vs {mr[:8]}")
    np.testing.assert_allclose(d, dr, rtol=1e-6)
    return float(np.abs(d - dr).max()) if len(d) else 0.0, m


def check_pixel_match(ops, ref, dev, crops):
    import numpy as np
    import torch
    r = np.random.default_rng(1)
    D = 3072

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    errs = []
    # tracker shape: the crops of two consecutive frames of the stream,
    # whose mean differences sit next to the 0.02 threshold
    crops, frames = crops
    flat = crops.reshape(len(crops), -1)
    counts = np.bincount(frames)
    f = 1 + int(np.argmax(np.minimum(counts[1:], counts[:-1])))
    tracker = (t(flat[frames == f]), t(flat[frames == f - 1]))
    errs.append(_match_pair(ops, ref, *tracker, 0.02)[0])
    # gate shape: 4 crops against a 512-entry ring, a planted tie (ring
    # entries 7 and 300 identical and nearest to crop 0) and a threshold
    # between the rows' minima
    b = r.random((512, D), dtype=np.float32)
    b[300] = b[7]
    a = r.random((4, D), dtype=np.float32)
    a[0] = np.clip(b[7] + r.normal(0, 0.01, D), 0, 1)
    err, m = _match_pair(ops, ref, t(a), t(b), 0.2)
    errs.append(err)
    check(m[0] == 7 and (m[1:] == -1).all(), f"gate tie / threshold: {m}")
    gate = (t(a), t(b))
    # strict threshold on exactly-summable values: mean |0 - 0.5| == 0.5
    z, h = np.zeros((3, D), np.float32), np.full((3, D), 0.5, np.float32)
    _, m = _match_pair(ops, ref, t(z), t(h), 0.5)
    check((m == -1).all(), "a mean exactly at the threshold must not match")
    _, m = _match_pair(ops, ref, t(z), t(h),
                       float(np.nextafter(np.float32(0.5), np.float32(1))))
    check((m == 0).all(), "ties go to the lowest index")
    # an empty side: all -1 and inf, no launch
    m, d = ops.pixel_match(t(z), t(np.zeros((0, D))), 0.5)
    check((m.cpu().numpy() == -1).all() and torch.isinf(d).all(), "empty")
    return max(errs), tracker, gate


def _dequant_pair(ops, ref, q, s, k, sg):
    import numpy as np
    import torch
    v, i = ops.dequant_topk(q, s, k, global_scale=sg)
    vr, ir = ref.dequant_topk_ref(q, s, k, sg)
    torch.cuda.synchronize()
    v, i, vr, ir = (x.cpu().numpy() for x in (v, i, vr, ir))
    check((i == ir).all(), f"dequant_topk indices differ at rows "
          f"{np.nonzero((i != ir).any(1))[0][:5].tolist()}")
    check((v == vr).all(), "dequant_topk values differ")
    return float(np.abs(v - vr).max()) if v.size else 0.0, i


def check_dequant_topk(ops, ref, dev):
    import numpy as np
    import torch
    r = np.random.default_rng(2)
    sg = np.float32(1.0 / 255.0)          # the v4 mean-prob multiplier
    errs = []
    # (dtype, M, C, k, top level): the path's full ranking, quantization
    # ties everywhere, ragged C with k < C, non-positive int8 rows, k < C
    # at the path's width; every case holds an all-zero row (scale 1)
    for dtype, M, C, k, hi in ((np.uint8, 300, 1000, 1000, 255),
                               (np.uint8, 64, 1000, 1000, 3),
                               (np.int8, 33, 37, 5, 127),
                               (np.int8, 7, 130, 130, 0),
                               (np.uint8, 50, 1000, 10, 255)):
        lo = 0 if dtype == np.uint8 else -127
        q = r.integers(lo, hi + 1, (M, C)).astype(dtype)
        s = (r.random(M) + 0.25).astype(np.float32)
        q[M // 2], s[M // 2] = 0, 1.0
        errs.append(_dequant_pair(ops, ref, torch.from_numpy(q).to(dev),
                                  torch.from_numpy(s).to(dev), k, sg)[0])
    # a planted tie goes to the lowest column
    q = torch.tensor([[3, 7, 7, 1, 7]], dtype=torch.uint8, device=dev)
    _, i = _dequant_pair(ops, ref, q, torch.ones(1, device=dev), 5, sg)
    check(i.tolist() == [[1, 2, 4, 0, 3]], f"dequant_topk ties: {i}")
    # M = 0: empty outputs, no launch
    n0 = ops.LAUNCHES["dequant_topk"]
    v, i = ops.dequant_topk(torch.zeros(0, 1000, dtype=torch.uint8,
                                        device=dev),
                            torch.zeros(0, device=dev), 7)
    check(v.shape == (0, 7) and i.shape == (0, 7)
          and ops.LAUNCHES["dequant_topk"] == n0, "dequant_topk M = 0")
    return max(errs)


def dequant_entry(ops, ref, dev, prefix, K, peaks):
    """``dequant_topk`` timed on one sealed shard's own quantized rows (the
    shape and data the archive path ranks), against its plain version and
    the library's dequant product plus a stable descending sort."""
    import numpy as np
    import torch
    from repro_torch.core.index import PROB_GLOBAL_SCALE as sg
    q = torch.from_numpy(np.load(prefix + ".mean_probs_q.npy")).to(dev)
    s = torch.from_numpy(np.load(prefix + ".prob_scales.npy")).float().to(dev)
    M, C = q.shape
    k = min(K, C)
    err, _ = _dequant_pair(ops, ref, q, s, k, sg)
    sg_t = torch.tensor(sg, device=q.device)
    n_bytes = M * C * q.element_size() + 4 * M + 8 * M * k
    return {
        "shape": [M, C, k], "dtype": str(q.dtype).replace("torch.", ""),
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.dequant_topk(q, s, k, global_scale=sg)),
        "plain_ms": time_ms(lambda: ref.dequant_topk_ref(q, s, k, sg)),
        "library_ms": time_ms(lambda: torch.sort(
            q.float() * (sg_t * s)[:, None], dim=1, descending=True,
            stable=True)),
        "bound_ms": 1e3 * n_bytes / peaks["bytes"], "bound_by": "bytes",
    }


def kernel_phase(ops, ref, dev, crops, peaks):
    import torch
    ca_err, (f, c, T) = check_centroid_assign(ops, ref, dev)
    pm_err, tracker, gate = check_pixel_match(ops, ref, dev, crops)
    dq_err = check_dequant_topk(ops, ref, dev)

    B, D = f.shape
    M = c.shape[0]
    ca_bytes = (B * D + M * D) * 4 + B * 9
    ca_ops = 2 * B * M * D
    ca = {
        "name": "centroid_assign", "route": "cuda",
        "source": "src/repro_torch/hopper/csrc/centroid_assign.cu",
        "replaces": "src/repro/kernels/centroid_assign.py:89",
        "shape": [B, M, D],
        "max_abs_err": ca_err,
        "ms": time_ms(lambda: ops.centroid_assign(f, c, threshold=T)),
        "plain_ms": time_ms(lambda: ref.centroid_assign_ref(f, c, T)),
        "library_ms": time_ms(
            lambda: torch.cdist(f, c).pow(2).min(1)),
        "bound_ms": 1e3 * max(ca_ops / peaks["fp32"],
                              ca_bytes / peaks["bytes"]),
        "bound_by": ("operations" if ca_ops / peaks["fp32"]
                     > ca_bytes / peaks["bytes"] else "bytes"),
    }

    def pm_entry(a, b):
        Na, Dp = a.shape
        Nb = b.shape[0]
        n = Na * Nb * Dp
        # per element: an fp32 subtract and abs, an fp64 add
        op_s = n * (2 / peaks["fp32"] + 1 / peaks["fp64"])
        by_s = ((Na + Nb) * Dp * 4 + Na * 8) / peaks["bytes"]
        return {
            "shape": [Na, Nb, Dp],
            "ms": time_ms(lambda: ops.pixel_match(a, b, 0.02)),
            "plain_ms": time_ms(lambda: ref.pixel_match_ref(a, b, 0.02)),
            "library_ms": time_ms(
                lambda: (torch.cdist(a, b, p=1) / Dp).min(1)),
            "bound_ms": 1e3 * max(op_s, by_s),
            "bound_by": "operations" if op_s > by_s else "bytes",
        }

    pm = {"name": "pixel_match", "route": "cuda",
          "source": "src/repro_torch/hopper/csrc/pixel_diff.cu",
          "replaces": "src/repro/kernels/pixel_diff.py:77",
          "max_abs_err": pm_err, **pm_entry(*tracker)}
    pm_gate = {"name": "pixel_match", **pm_entry(*gate)}
    dq = {"name": "dequant_topk", "route": "cuda",
          "source": "src/repro_torch/hopper/csrc/dequant_topk.cu",
          "replaces": "src/repro/kernels/dequant_topk.py:56",
          "max_abs_err": dq_err}
    return ca, pm, pm_gate, dq


# ---------------------------------------------------------------------------
# phase 4: card against CPU
# ---------------------------------------------------------------------------

def card_vs_cpu(serve_args):
    import numpy as np
    import torch
    from repro_torch.common.config import CHEAP_CNNS
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.ingest import IngestConfig, ingest
    from repro_torch.core.query import dominant_classes
    from repro_torch.core.streaming import StreamingIngestor
    from repro_torch.data.video import get_stream, gt_oracle
    from repro_torch.models import cnn

    crops, frames, _, labels = get_stream(
        "jacksonh", duration_s=60, fps=30).objects_array()
    mcfg = CHEAP_CNNS["cheap1"]
    tree = cnn.init_params(mcfg, seed=0)
    probs, feats = cnn.make_apply(cnn.build(mcfg, tree, "cuda"))(crops)
    probs_c, feats_c = cnn.make_apply(cnn.build(mcfg, tree, "cpu"))(crops)
    cnn_err = max(float(np.abs(probs - probs_c).max()),
                  float(np.abs(feats - feats_c).max()))
    check(cnn_err <= 1e-4, f"CNN card vs CPU: {cnn_err}")
    row = {c.tobytes(): i for i, c in enumerate(crops)}

    def cheap(batch):
        ix = np.array([row[c.tobytes()] for c in batch], np.int64)
        return probs[ix], feats[ix]

    workload = [int(x) for x in dominant_classes(labels)]
    out = {"objects": int(len(crops)), "cnn_max_abs_err": cnn_err,
           "configs": []}
    for cfg in (IngestConfig(K=serve_args["K"], threshold=serve_args["T"]),
                IngestConfig(K=serve_args["K"], threshold=serve_args["T"],
                             max_clusters=16, high_water=0.8,
                             evict_frac=0.5)):
        idx = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            idx[dev], stats = ingest(crops, frames, cheap, 0.0, cfg,
                                     n_local_classes=1000, device=dev)
            torch.cuda.synchronize()
            out[f"ingest_{dev}_s"] = time.perf_counter() - t0
        check(idx["cuda"].save_bytes() == idx["cpu"].save_bytes(),
              "card and CPU indexes differ")
        ing = StreamingIngestor(cheap, 0.0, cfg, n_local_classes=1000,
                                device="cuda")
        bounds = np.linspace(0, len(crops), 6).astype(int)
        for lo, hi in zip(bounds, bounds[1:]):
            ing.feed(crops[lo:hi], frames[lo:hi])
            ing.flush()
        chunked, _ = ing.finish()
        check(chunked.save_bytes() == idx["cuda"].save_bytes(),
              "chunked and one-shot indexes differ on the card")
        answers = {}
        for dev in ("cuda", "cpu"):
            res, _ = QueryEngine(idx[dev], gt_apply=gt_oracle(labels)
                                 ).query_many(workload)
            answers[dev] = [r.frames.tolist() for r in res]
        check(answers["cuda"] == answers["cpu"], "answers differ")
        out["configs"].append({
            "max_clusters": cfg.max_clusters, "K": cfg.K, "T": cfg.threshold,
            "clusters": idx["cuda"].n_clusters,
            "evictions": stats.n_evictions,
            "answered_frames": int(sum(len(a) for a in answers["cuda"])),
            "bytes_identical": True, "chunked_equals_oneshot": True})
    out["archive"] = archive_card_vs_cpu(crops, frames, labels, cheap,
                                         workload, serve_args)
    return out


def archive_card_vs_cpu(crops, frames, labels, cheap, workload, serve_args,
                        shard_objects=512):
    """Shards sealed on the card (chunked and one-shot) and on the CPU are
    byte-identical; the lazy archive engine (``dequant_topk`` on the card,
    its plain version on the CPU) answers like eagerly loaded shards."""
    import numpy as np
    import torch
    from repro_torch.core.archive import ArchiveQueryEngine, ShardCatalog
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.index import saved_file_bytes
    from repro_torch.core.ingest import IngestConfig
    from repro_torch.core.streaming import StreamingIngestor
    from repro_torch.data.video import gt_oracle

    cfg = IngestConfig(K=serve_args["K"], threshold=serve_args["T"])
    gt = gt_oracle(labels)
    with tempfile.TemporaryDirectory() as root:
        cats = {}
        for name, dev, n_chunks in (("cuda_chunked", "cuda", 5),
                                    ("cuda", "cuda", 1), ("cpu", "cpu", 1)):
            cat = ShardCatalog.open(os.path.join(root, name))
            ing = StreamingIngestor(cheap, 0.0, cfg, n_local_classes=1000,
                                    catalog=cat, shard_objects=shard_objects,
                                    device=dev)
            bounds = np.linspace(0, len(crops), n_chunks + 1).astype(int)
            for lo, hi in zip(bounds, bounds[1:]):
                ing.feed(crops[lo:hi], frames[lo:hi])
                ing.flush()
            ing.finish()
            torch.cuda.synchronize()
            cats[name] = cat
        ref_cat = cats["cpu"]
        check(len(ref_cat) > 1, "the archive cut sealed one shard")
        for name, cat in cats.items():
            check([vars(m) for m in cat] == [vars(m) for m in ref_cat],
                  f"{name} manifest differs from the CPU's")
            for m in cat:
                check(saved_file_bytes(cat.path_of(m.shard_id))
                      == saved_file_bytes(ref_cat.path_of(m.shard_id)),
                      f"{name} shard {m.shard_id} differs from the CPU's")
        answers = {}
        for name, dev in (("cuda", "cuda"), ("cpu", "cpu")):
            res, _ = ArchiveQueryEngine(cats[name], gt_apply=gt,
                                        device=dev).query_many(workload)
            answers[name] = [r.frames.tolist() for r in res]
        eager = []
        for cls in workload:
            parts = [QueryEngine(ref_cat.load_shard(m.shard_id),
                                 gt_apply=gt).query(cls).frames
                     for m in ref_cat]
            eager.append(np.unique(np.concatenate(parts)).tolist())
        check(answers["cuda"] == answers["cpu"] == eager,
              "lazy archive answers differ (card, CPU, eager)")
        return {"shard_objects": shard_objects, "shards": len(ref_cat),
                "clusters": sum(m.n_clusters for m in ref_cat),
                "answered_frames": int(sum(len(a) for a in eager)),
                "bytes_identical": True, "chunked_equals_oneshot": True,
                "lazy_equals_eager": True}


# ---------------------------------------------------------------------------
# phase 5: where the ingest time goes
# ---------------------------------------------------------------------------

def breakdown(serve_args, duration=120):
    """Host wall time per ingest stage on a cut of the stream, with the card
    synchronised around every stage so each is charged its own device
    work. Run after the other phases: the stage wrappers are measurement
    only and are removed before it returns."""
    import torch
    from repro_torch.common.config import CHEAP_CNNS
    from repro_torch.core import clustering as C
    from repro_torch.core import streaming as S
    from repro_torch.core.index import TopKIndex
    from repro_torch.core.ingest import IngestConfig, ingest
    from repro_torch.data.video import get_stream
    from repro_torch.models import cnn

    crops, frames, _, _ = get_stream(
        "jacksonh", duration_s=duration, fps=30).objects_array()
    mcfg = CHEAP_CNNS["cheap1"]
    apply = cnn.make_apply(cnn.build(mcfg, cnn.init_params(mcfg, 0), "cuda"))
    spent, calls = {}, {}
    rows = {"unmatched": 0, "padded": 0}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            calls[name] = calls.get(name, 0) + 1
            return out
        return wrapper

    def count_rows(fn):
        def wrapper(state, sub, valid, threshold):
            rows["padded"] += len(sub)
            rows["unmatched"] += int(valid.sum())
            return fn(state, sub, valid, threshold)
        return wrapper

    stages = [(C, "_phase1", "phase1_kernel"), (C, "_fold_matched", "fold"),
              (C, "_scan_unmatched", "unmatched_scan"),
              (S, "pixel_difference", "pixel_tracker"),
              (TopKIndex, "add_batch", "index_fold")]
    originals = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in stages]
    for (obj, attr, name), (_, _, fn) in zip(stages, originals):
        setattr(obj, attr, timed(name, fn))
    C._scan_unmatched = count_rows(C._scan_unmatched)
    try:
        t0 = time.perf_counter()
        index, stats = ingest(crops, frames, timed("cnn", apply), 0.0,
                              IngestConfig(K=serve_args["K"],
                                           threshold=serve_args["T"]),
                              n_local_classes=1000, device="cuda")
        total = time.perf_counter() - t0
    finally:
        for obj, attr, fn in originals:
            setattr(obj, attr, fn)
    return {"duration_s": duration, "objects": int(len(crops)),
            "clusters": index.n_clusters, "total_s": total,
            "stages_s": spent, "calls": calls,
            "other_s": total - sum(spent.values()), **{
                f"scan_{k}_rows": v for k, v in rows.items()}}


def main():
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this script runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("[chip_smoke] src/repro_torch not found: run from the root of "
              "a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.common.device import resolve_device
    from repro_torch.data.video import get_stream
    from repro_torch.hopper import build, ops, ref
    from repro_torch.launch import serve

    # -- phase 1: the card and the build --------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    build.load()
    emit({"phase": "build", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks": peaks,
          "build_s": time.perf_counter() - t0,
          "nvcc_s": build.build_seconds})

    # -- phase 2: kernels against plain versions ------------------------------
    crops, frames = get_stream("jacksonh", duration_s=10,
                               fps=30).objects_array()[:2]
    ca, pm, pm_gate, dq = kernel_phase(ops, ref, dev, (crops, frames), peaks)
    emit({"phase": "kernels", "gpu": smi, "pixel_match_gate_shape": pm_gate,
          "elapsed_s": elapsed()})

    # -- phase 3: the served paths -------------------------------------------
    # seeded random weights rank the same classes first for every crop, so
    # the index ranks all 1000 classes (K=1000) and clusters at T=0.4, where
    # the random features still separate tracks: every query then reaches
    # the GT pass
    serve_args = {"K": 1000, "T": 0.4}
    duration = 600
    argv = ["--stream", "jacksonh", "--duration", str(duration),
            "--fps", "30", "--model", "cheap1", "--seed", "0",
            "--tenants", "4", "--rounds", "3", "--K", str(serve_args["K"]),
            "--T", str(serve_args["T"]), "--device", "cuda"]

    def drive(path, path_argv, kernels):
        """One served path, its launch counters zeroed just before it and
        read just after; each of ``kernels`` must have launched."""
        ops.reset_launches()
        t0 = time.perf_counter()
        report = serve.main(path_argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        check(all(launches[k] > 0 for k in kernels),
              f"a kernel of the {path} path never launched: {launches}")
        check(report["clusters"] > 1 and report["objects"] > 0,
              f"empty ingest on the {path} path")
        check(sum(len(f) for f in report["answers"].values()) > 0,
              f"no query answered a frame on the {path} path")
        for k in ("precision", "recall"):
            check(report[k] is not None and 0.0 <= report[k] <= 1.0, k)
        emit({"phase": f"{path}_path", "gpu": smi, "argv": path_argv,
              "duration_s": duration, "wall_s": wall, "launches": launches,
              **{k: v for k, v in report.items() if k != "answers"}})
        return report, launches

    _, oneshot = drive("oneshot", argv, ("centroid_assign", "pixel_match"))
    with tempfile.TemporaryDirectory() as arch:
        archive_argv = argv + ["--archive", arch, "--shard-objects", "2048",
                               "--stream-chunks", "8"]
        report, archive = drive("archive", archive_argv, tuple(ops.LAUNCHES))
        check(report["shards"] > 1, "the archive path sealed one shard")
        with open(os.path.join(arch, "catalog.json")) as f:
            shards = json.load(f)["shards"]
        largest = max(shards, key=lambda m: m["n_clusters"])
        entry = dequant_entry(ops, ref, dev,
                              os.path.join(arch, largest["path"]),
                              serve_args["K"], peaks)
    entry["max_abs_err"] = max(entry["max_abs_err"], dq["max_abs_err"])
    dq.update(entry)
    for entry in (ca, pm):
        entry["launches"] = oneshot[entry["name"]]
        entry["launches_archive"] = archive[entry["name"]]
    dq["launches"] = archive["dequant_topk"]

    # -- phase 4: card against CPU --------------------------------------------
    emit({"phase": "card_vs_cpu", **card_vs_cpu(serve_args),
          "elapsed_s": elapsed()})
    emit({"phase": "breakdown", "gpu": smi, **breakdown(serve_args),
          "elapsed_s": elapsed()})
    check(elapsed() < LIMIT_S, f"over the {LIMIT_S} s limit")

    emit({"kernels": [ca, pm, dq]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
