#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: the quickest proof that the port builds, is right, and serves on
the card.

  python3 chip_smoke.py                 # from the root of a checkout
  python3 chip_smoke.py --compare DIR   # the default serve, the 600 s
                                        # one-shot, background subtraction
                                        # and the shared kernels, the tree
                                        # at DIR (a parent commit) against
                                        # this one

Phases, each fatal on failure (no phase's failure is caught):

1. the card (``nvidia-smi``), torch/CUDA versions, and the build of the
   six Hopper kernels from ``src/repro_torch/hopper/csrc``;
2. every kernel against its plain PyTorch version on the card, at the
   main path's shapes plus ragged, tie, dead-slot, threshold-edge and
   empty cases, with its design, its time, the plain version's, one
   PyTorch library call's (a yardstick only; the port never calls it;
   none computes ``motion_gate``'s function nor ``pixel_match`` over
   ranges) and its bound, each time both host-inclusive (CUDA events
   around 50 calls) and on the device (``torch.profiler``, with its
   device events per call);
   ``pixel_match`` is timed on the tracker's window of a 120 s one-shot
   ingest (7373 crops, each against its previous frame, one launch),
   with a 20000-row range merged inside the launch among its checks, and
   the tracker itself is timed batched against a per-frame loop of
   launches over the same 120 s (roots identical, and equal to the
   CPU's); ``centroid_assign`` must run at least a block per SM, and its
   stacked launch (8 stream slots of 512 rows against M in {2048, 4096},
   a slot with n = 0, an idle slot, ragged B, ties across tiles) must give
   every slot its solo launch's bits, timed against 8 solo launches, with
   the stacked unmatched tail against solo scans, bitwise; ``topk`` is
   timed on a batch of the cheap CNN's own probabilities (with a -0.0
   against +0.0 tie among its checks), ``dequant_topk`` also on rows whose
   distinct levels collide (a scale underflowing to 0, levels overflowing
   to inf), ``motion_gate_frames`` (one launch per window) on a window of
   the stream's 128 x 128 frames as background subtraction cuts it, on a
   720p window, ragged shapes, a window of one, static frames, a tile
   mean at the threshold and alpha 0 and 1, and timed on the first two,
   ``motion_gate`` (its one-frame case) at 128 x 128 and at 720p,
   ``flash_attention`` at the LM prefill's
   (B=4, S=2048, H=16, dh=128) in bf16 against SDPA, with its achieved
   TFLOP/s on the bf16 tensor cores, after the fp32 and bf16 cases,
   ragged S, every head width, full attention and a grouped-KV layer
   through ``layers.multihead_attention``;
3. the default serve path of ``repro_torch.launch.serve`` (no
   ``--model/--K/--T``) on the busiest stream (jacksonh, 120 s at 30 fps,
   4 tenants, 3 rounds): it trains spec1-spec3 (each logged loss finite,
   each model's last logged loss below its first), sweeps (model, K, T),
   selects, ingests with the chosen model and serves; then the same
   serve with ``--mesh-devices 1 --stream-chunks 8`` on the models just
   trained (ingest through the sharded pipeline on a one-card mesh): the
   same choice and answers as the one-shot; then §6.1
   background subtraction: the same 120 s as 3600 full frames through
   ``BackgroundSubtractor(device="cuda")`` in turns per-frame, windowed,
   windowed, per-frame (one ``motion_gate`` launch per frame after the
   first, or one per window through ``process``), boxes and background
   identical in all four, stages in ms/frame, and ``extract_crops``;
   then the two override
   paths (``--model cheap1 --seed 0 --K 1000 --T 0.4``: seeded random
   weights rank the same classes first for every crop, so K=1000 makes
   every query reach the GT pass) on jacksonh 600 s with the full-width
   cheap1 CNN: the one-shot ingest, then the archive (``--archive`` into
   a temporary directory, 2048 objects per shard, 8 chunks with tenants
   querying between them); then the
   fused ingest pipeline (``IngestPipeline`` with a ``topk_sink``, which
   no entry point passes) on the same stream with the config the serve
   path builds, against the staged path (``staged_cheap_apply``) in turns
   staged, pipeline, pipeline, staged: all four indexes byte-identical,
   and a rollover run on a 120 s cut (2048 objects per shard, 8 chunks)
   whose shards equal the staged rollover's; then multi-stream ingest
   (``multistream_path``): eight 120 s streams of the zoo (traffic,
   surveillance, news) through ``make_sharded_runner`` on
   ``make_ingest_mesh(1)`` with a ``topk_sink``, 4 chunks a stream per
   round, interleaved, each stream's index, counters and sink equal to
   its solo ``IngestPipeline``'s, ``centroid_assign`` and ``topk`` once per
   stacked step, ≤ 2 dispatches a step; the staged ``MultiStreamRunner``
   over the same streams equal too; a rollover on a 30 s cut (2048
   objects per shard) equal to solo rollovers; ``make_ingest_mesh`` past
   the card count raising its actionable error. Each path's launch counters
   are zeroed just before it and read just after: the one-shot path must
   launch ``centroid_assign`` and ``pixel_match``, the archive path those
   and ``dequant_topk``, the pipeline path ``centroid_assign``,
   ``pixel_match`` and ``topk``, once per megastep, and the default path
   and the background subtraction theirs. ``dequant_topk`` is then timed
   on the largest sealed shard's own quantized rows. Last, the LM serving
   path (``lm_path``): olmo-1b at full width in bf16 from
   ``transformer.init(cfg, seed=0)``, the prefill of 4 prompts of 2048
   tokens through the flash route (16 ``flash_attention`` launches per
   call, the only launches of the path) and the einsum route, and
   KV-cache decode of 4 sequences (a 32-token prompt, then 32 greedy
   tokens); then, on the same weights in fp32, the two routes' prefill
   logits and ``decode_step`` against ``forward`` within 1e-4 of the
   largest |logit|;
4. card against CPU: the 120 s of frames through
   ``BackgroundSubtractor(device="cpu")`` give the card's boxes on every
   frame and its final background bit for bit; on a 60 s cut, spec1-spec3
   trained on the card and swept on the card and on the CPU over the
   same CNN outputs give identical ``ConfigEval``s, the same choice and
   identical index bytes for it (the trained CNNs' own outputs on the two
   devices agree to atol 1e-4, which a cluster threshold could split),
   and spec1 trained 10 steps on each from one ``init=`` ends within 1e-3
   (cuDNN sums conv gradients in another order); on the same cut the same
   cheap1 outputs ingested on ``cuda`` and on ``cpu`` save byte-identical
   indexes and answer identically, a 5-chunk ingest on the card saves the same bytes
   as one-shot, and the CNN's outputs agree to atol 1e-4; likewise for
   the archive: card-chunked, card one-shot and CPU shards byte-identical,
   and lazy (kernel-ranked) answers equal eagerly loaded shards' and the
   CPU's; and for the pipeline: the card's and the CPU's pipelines and
   the CPU's staged path save identical bytes, and the two sinks hold
   identical top-K; the LM at olmo-1b's width with 2 layers in fp32 gives
   the CPU's prefill (flash route) and decode logits within 1e-4 of the
   largest |logit|, and the threefry draws of the cheap CNNs and of a
   reduced LM are bitwise equal on the card and on the CPU;
5. where the ingest time goes: wall time per stage on a 120 s cut, for
   the override path's cheap1 (K=1000, T=0.4) and for the default path's
   chosen model at its K and T; then each path's ``pixel_match`` and
   ``centroid_assign`` launches on one line.

Earlier lines are JSON objects, one per line; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a card, or when
run anywhere but the root of a checkout. Tolerances: indices, ``matched``
and match decisions exact; squared distances rtol 1e-5 (fp32 dot products
summed in another order; atol 1e-4 where a distance cancels to ~0); mean
pixel differences rtol 1e-6; ``dequant_topk`` and ``topk`` values and
indices exact; ``motion_gate``'s new background, tile means and hot mask
bitwise; ``flash_attention`` fp32 atol = rtol = 2e-5 (the JAX package's
own), bf16 one ulp: rtol 2**-7, atol 1e-4 (kernel and plain version each
round one fp32 result to bf16 once).
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
# variant nvidia-smi names: fp32 and fp64 outside the tensor cores, bf16 on
# the tensor cores, and device-memory bandwidth.
PEAKS = {
    "PCIe": {"fp32": 51.2e12, "fp64": 25.6e12, "bf16_tc": 756e12,
             "bytes": 2.0e12},
    "NVL": {"fp32": 60.0e12, "fp64": 30.0e12, "bf16_tc": 835e12,
            "bytes": 3.9e12},
    "SXM": {"fp32": 67.0e12, "fp64": 34.0e12, "bf16_tc": 989e12,
            "bytes": 3.35e12},
}

# The LM path: olmo-1b at full width in its config's bf16, prefilling 4
# prompts of OLMo-1B's 2048-token context, then decoding 4 sequences into
# a 2048-slot cache (a 32-token prompt one token at a time, then 32
# greedy tokens).
LM_ARCH = "olmo-1b"
LM_BATCH, LM_SEQ = 4, 2048
DECODE_PROMPT, DECODE_NEW, DECODE_SLOTS = 32, 32, 2048
# phase 4's card-against-CPU LM: olmo-1b's width with 2 layers
LM_CPU_LAYERS, LM_CPU_BATCH, LM_CPU_SEQ = 2, 2, 256


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


def stage_timer(spent, calls):
    """``timed(name, fn)``: ``fn`` wrapped to add its host wall time, with
    the card synchronised before and after, to ``spent[name]`` and one to
    ``calls[name]``."""
    import torch

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
    return timed


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


def graph_ms(fn, iters=50):
    """Device time per call from one CUDA-graph replay of ``iters`` calls
    (no host launch cost between them). ``fn`` must be capturable: no
    host sync, no pageable copy."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DEVICE_TIME_SOURCE = {}         # how device times were taken in this run


def device_profile(fn, iters=20, tries=3):
    """(device ms per call, device events per call): the card's kernel,
    copy and memset durations and their number, summed under
    ``torch.profiler`` over ``iters`` calls after a warm-up. The profiler
    can lose events (on an H100, sessions without a warm-up step recorded
    0.75-0.8 of the calls' events for four kernels in one run, which
    reads as a shorter device time), so each session records a warm-up
    step of ``iters`` calls before the step it reports, and a session whose
    events are not a whole number per call is taken again, up to
    ``tries`` times; the count is returned beside the time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages()
                  if getattr(e, "self_device_time_total", 0.0) > 0]
        n = sum(e.count for e in events)
        if n % iters == 0:
            break
    us = sum(e.self_device_time_total for e in events)
    return us / iters / 1e3, n / iters


def device_ms(fn, iters=20, capturable=True):
    """(device time per call, device events per call) from
    ``device_profile``. Where the profiler sees no device time, a
    CUDA-graph replay of 50 calls for a capturable ``fn``, else None (not
    measured), with no event count."""
    ms, n = device_profile(fn, iters)
    if ms > 0:
        DEVICE_TIME_SOURCE["profiler"] = True
        return ms, n
    DEVICE_TIME_SOURCE["graph"] = True
    return (graph_ms(fn) if capturable else None), None


def timings(kernel, plain, library=None, plain_iters=50):
    """The kernel's, the plain version's and the library call's times:
    host-inclusive CUDA-event means (``ms``, ``plain_ms``, ``library_ms``)
    and device times beside them (``device_ms``, ...), each with the
    profiler's device events per call. The plain versions read ranges or
    thresholds from the host, so their device time comes from the
    profiler only."""
    out = {"ms": time_ms(kernel), "plain_ms": time_ms(plain,
                                                      iters=plain_iters),
           "library_ms": None, "library_device_ms": None}
    out["device_ms"], out["device_events_per_call"] = device_ms(kernel)
    out["plain_device_ms"], out["plain_device_events_per_call"] = device_ms(
        plain, iters=min(20, plain_iters), capturable=False)
    if library is not None:
        out["library_ms"] = time_ms(library)
        out["library_device_ms"], out["library_device_events_per_call"] = \
            device_ms(library)
    return out


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
    # zero features against centroids of +0.0 and -0.0 entries: every
    # partial score is +0.0, the dot products either sign; ties go to 1
    cz = np.ones((5, D), np.float32)
    cz[1], cz[2], cz[3] = -0.0, 0.0, -0.0
    cz[3, ::2] = 0.0
    _, j, m = _assign_pair(ops, ref, t(np.zeros((3, D))), t(cz), 0.5)
    check(j.tolist() == [1, 1, 1] and m.all(), f"signed zeros: {j}")
    # ragged B and M, and the default serve's M = 2048 (live slots only)
    errs.append(_assign_pair(ops, ref, t(r.normal(size=(130, D))),
                             t(r.normal(size=(333, D))), 15.5)[0])
    errs.append(_assign_pair(ops, ref, t(f), t(c[:2048]), T)[0])
    return max(errs), (t(f), t(dead), T)


def check_centroid_assign_stacked(ops, ref, dev, peaks):
    """The stacked launch (one per step of the multi-stream pipeline) at
    the path's shapes, S = 8 slots of B = 512 against M in {2048, 4096},
    D = 128: bitwise against S solo launches, indices and matches exact
    against the plain version; slot 2 has n = 0 (every row dead at 1e9),
    slot 5 is idle (all-zero features), the tables' halves are duplicates
    (ties across centroid tiles) and a ragged B = 300 runs too. Then the
    stacked unmatched tail (``clustering._StackedScan``) against solo
    scans, bitwise. Returns (max |d2 - plain|, the timed entry at M =
    4096: stacked against S solo launches, host-inclusive and device)."""
    import numpy as np
    import torch
    from repro_torch.core import clustering as C
    from repro_torch.hopper import build
    r = np.random.default_rng(19)
    S, B, D, T = 8, 512, 128, 15.0

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    errs, entry = [], None
    for M in (2048, 4096):
        f = r.normal(size=(S, B, D)).astype(np.float32)
        c = r.normal(size=(S, M, D)).astype(np.float32)
        c[:, M // 2:] = c[:, :M // 2]
        c[2] = 1e9
        f[5] = 0.0
        F, Cc = t(f), t(c)
        for rows in (B, 300):
            Fr = F[:, :rows].contiguous()
            before = ops.LAUNCHES["centroid_assign"]
            got = ops.centroid_assign_stacked(Fr, Cc, threshold=T)
            check(ops.LAUNCHES["centroid_assign"] == before + 1,
                  "centroid_assign_stacked is not one launch")
            want = ref.centroid_assign_stacked_ref(Fr, Cc, T)
            for s in range(S):
                solo = ops.centroid_assign(Fr[s], Cc[s], threshold=T)
                check(all(torch.equal(a[s], b) for a, b in zip(got, solo)),
                      f"stacked slot {s} differs from its solo launch "
                      f"(M={M}, B={rows})")
            torch.cuda.synchronize()
            check(torch.equal(got[1], want[1]) and torch.equal(got[2],
                                                               want[2]),
                  f"stacked indices or matches differ from the plain "
                  f"version (M={M}, B={rows})")
            check((got[1][2] == 0).all() and not got[2][2].any(),
                  "the n = 0 slot must give index 0, nothing matched")
            live = torch.ones(S, dtype=torch.bool, device=dev)
            live[2] = False                 # d2 of dead rows is ~1e20
            d2, d2r = got[0][live].cpu().numpy(), want[0][live].cpu().numpy()
            np.testing.assert_allclose(d2, d2r, rtol=1e-5, atol=1e-4)
            errs.append(float(np.abs(d2 - d2r).max()))
        if M == 4096:
            blocks = S * build.load().centroid_assign_blocks(B, M)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            solo = lambda: [ops.centroid_assign(F[s], Cc[s],  # noqa: E731
                                                threshold=T)
                            for s in range(S)]
            n_ops = 2 * S * B * M * D
            n_bytes = (S * B * D + S * M * D) * 4 + S * B * 9
            entry = {"shape": [S, B, M, D], "blocks": blocks,
                     "blocks_per_sm": blocks / sms,
                     **timings(lambda: ops.centroid_assign_stacked(
                         F, Cc, threshold=T),
                         lambda: ref.centroid_assign_stacked_ref(F, Cc, T),
                         lambda: torch.cdist(F, Cc).pow(2).min(-1)),
                     "solo_launches_ms": time_ms(solo),
                     "bound_ms": 1e3 * max(n_ops / peaks["fp32"],
                                           n_bytes / peaks["bytes"]),
                     "bound_by": ("operations" if n_ops / peaks["fp32"]
                                  > n_bytes / peaks["bytes"] else "bytes")}
            entry["solo_launches_device_ms"], \
                entry["solo_launches_device_events"] = device_ms(solo)
    # the stacked unmatched tail against each slot's solo scan
    M, P = 4096, 32
    cen = t(r.normal(size=(S, M, D)) * 3)
    cnt = torch.from_numpy(r.integers(1, 5, (S, M)).astype(np.int32)).to(dev)
    n = torch.from_numpy(r.integers(0, M // 2, S).astype(np.int32)).to(dev)
    n[2] = 0
    sub = t(r.normal(size=(S, P, D)) * 3)
    valid = torch.from_numpy(r.random((S, P)) < 0.8).to(dev)
    valid[5] = False                    # a slot that rides along
    solo = [C._scan_unmatched(C.ClusterState(cen[w], cnt[w], n[w]), sub[w],
                              valid[w], 4.0) for w in range(S)]
    state = C.ClusterState(cen.clone(), cnt.clone(), n.clone())
    ids = C._scan_unmatched_stacked(state, sub, valid, 4.0)
    torch.cuda.synchronize()
    for w, (st, sid) in enumerate(solo):
        check(torch.equal(state.centroids[w], st.centroids)
              and torch.equal(state.counts[w], st.counts)
              and torch.equal(state.n[w], st.n) and torch.equal(ids[w], sid),
              f"the stacked tail differs from slot {w}'s solo scan")
    return max(errs), entry


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
    n0 = ops.LAUNCHES["pixel_match"]
    m, d = ops.pixel_match(t(z), t(np.zeros((0, D))), 0.5)
    check((m.cpu().numpy() == -1).all() and torch.isinf(d).all()
          and ops.LAUNCHES["pixel_match"] == n0, "empty")
    # one 20000-row range, split over the card and merged in the launch;
    # a planted pair of equal nearest rows far apart (the lower wins)
    b = r.random((20000, D), dtype=np.float32)
    b[17000] = b[4321]
    a = r.random((4, D), dtype=np.float32)
    a[0] = np.clip(b[4321] + r.normal(0, 0.01, D), 0, 1)
    lo = torch.zeros(4, dtype=torch.int32, device=dev)
    hi = torch.full((4,), 20000, dtype=torch.int32, device=dev)
    err, m = _ranges_pair(ops, ref, t(a), t(b), lo, hi, 0.2)
    errs.append(err)
    check(m.tolist() == [4321, -1, -1, -1], f"long range: {m}")
    window = tracker_window(crops, frames, dev)
    err, m = _ranges_pair(ops, ref, *window, 0.02)
    errs.append(err)
    check(bool((window[3] > window[2]).any()), "tracker window: no range")
    return max(errs), tracker, gate, window


def _ranges_pair(ops, ref, a, b, lo, hi, thr):
    """``pixel_match_ranges`` against its plain version: one launch,
    indices exact, means to rtol 1e-6."""
    import numpy as np
    import torch
    n0 = ops.LAUNCHES["pixel_match"]
    m, d = ops.pixel_match_ranges(a, b, lo, hi, thr)
    check(ops.LAUNCHES["pixel_match"] == n0 + 1, "one launch per call")
    mr, dr = ref.pixel_match_ranges_ref(a, b, lo, hi, thr)
    torch.cuda.synchronize()
    m, d, mr, dr = (x.cpu().numpy() for x in (m, d, mr, dr))
    check((m == mr).all(), f"pixel_match_ranges differs at "
          f"{np.nonzero(m != mr)[0][:5].tolist()}")
    fin = np.isfinite(dr)
    check((np.isfinite(d) == fin).all(), "empty ranges differ")
    np.testing.assert_allclose(d[fin], dr[fin], rtol=1e-6)
    return float(np.abs(d[fin] - dr[fin]).max()) if fin.any() else 0.0, m


def tracker_window(crops, frames, dev):
    """The tracker's launch on a one-shot ingest of ``crops``: the whole
    frame-sorted stream in one buffer (it fits one window), each crop's
    range the rows of its previous frame. Returns (a, b, lo, hi) on the
    card, a a view into b."""
    import numpy as np
    import torch
    order = np.argsort(frames, kind="stable")
    fs = frames[order]
    rows = torch.from_numpy(np.ascontiguousarray(
        crops[order].reshape(len(fs), -1), np.float32)).to(dev)
    lo = np.searchsorted(fs, fs - 1, side="left")
    hi = np.searchsorted(fs, fs - 1, side="right")
    bounds = torch.from_numpy(np.stack([lo, hi]).astype(np.int32)).to(dev)
    return rows, rows, bounds[0], bounds[1]


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
    # distinct q with equal values rank by column: a scale whose product
    # with 1/255 underflows to 0 (every q; int8's -0.0 with +0.0), top
    # levels overflowing to inf at a global scale of 1, a subnormal scale
    # (exact, not flushed) and a negative one; held bitwise against the
    # plain version on the CPU (the card's sort orders -0.0 below +0.0)
    for dtype in (np.uint8, np.int8):
        lo = 0 if dtype == np.uint8 else -127
        q = r.integers(lo, 128, (6, 1000)).astype(dtype)
        q[:, :6] = np.array([0, 5, 0, 127, 5, 1], dtype)
        for g, scales in ((sg, [1e-44, 0.5, 7e-45, 2.0, 1.0, 3e38]),
                          (np.float32(1.0), [3e36, 1e-44, -0.25, 1e-40,
                                             0.0, 1.0])):
            qt = torch.from_numpy(q)
            st = torch.tensor(scales, dtype=torch.float32)
            v, i = ops.dequant_topk(qt.to(dev), st.to(dev), 1000,
                                    global_scale=g)
            vr, ir = ref.dequant_topk_ref(qt, st, 1000, g)
            check(torch.equal(i.cpu(), ir) and torch.equal(
                v.cpu().view(torch.int32), vr.view(torch.int32)),
                f"dequant_topk colliding values differ ({dtype.__name__}, "
                f"global scale {g})")
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
        **timings(lambda: ops.dequant_topk(q, s, k, global_scale=sg),
                  lambda: ref.dequant_topk_ref(q, s, k, sg),
                  lambda: torch.sort(q.float() * (sg_t * s)[:, None], dim=1,
                                     descending=True, stable=True)),
        "bound_ms": 1e3 * n_bytes / peaks["bytes"], "bound_by": "bytes",
    }


def _topk_pair(ops, ref, x, k):
    import numpy as np
    import torch
    v, i = ops.topk(x, k)
    vr, ir = ref.topk_ref(x, k)
    torch.cuda.synchronize()
    v, i, vr, ir = (t.cpu().numpy() for t in (v, i, vr, ir))
    check((i == ir).all(), f"topk indices differ at rows "
          f"{np.nonzero((i != ir).any(1))[0][:5].tolist()}")
    check((v == vr).all(), "topk values differ")
    return float(np.abs(v - vr).max()) if v.size else 0.0, i


def check_topk(ops, ref, dev, probs):
    """``topk`` against its plain version: the cheap CNN's own batch at
    the pipeline's shape (512 x 1000, k = 1000), ties everywhere, k < C,
    ragged C, the widest row (12288 columns, 16384 keys), one past a power
    of two, a row of equal values in each, a planted tie, -0.0 against
    +0.0 and B = 0."""
    import numpy as np
    import torch
    r = np.random.default_rng(3)
    errs = [_topk_pair(ops, ref, probs, probs.shape[1])[0]]
    for B, C, k, levels in ((512, 1000, 1000, 4), (64, 1000, 10, None),
                            (33, 37, 5, None), (7, 130, 130, 2),
                            (3, 12288, 1, None), (9, 1025, 1025, 3)):
        x = r.random((B, C), dtype=np.float32)
        if levels is not None:
            x = np.floor(x * levels).astype(np.float32)
        x /= x.sum(1, keepdims=True) + 1
        x[B // 2] = 0.5
        errs.append(_topk_pair(ops, ref, torch.from_numpy(x).to(dev), k)[0])
    _, i = _topk_pair(ops, ref, torch.tensor([[1.0, 3, 3, 2, 3]],
                                             device=dev), 3)
    check(i.tolist() == [[1, 2, 4]], f"topk ties: {i}")
    # -0.0 ties with +0.0 (the JAX kernel compares with ==): held to the
    # plain version on the CPU, the values bit for bit
    z = torch.tensor([[0.0, -0.0, 0.5, -0.0, 0.0]])
    v, i = ops.topk(z.to(dev), 5)
    vr, ir = ref.topk_ref(z, 5)
    v, i = v.cpu(), i.cpu()
    check(i.tolist() == ir.tolist() == [[2, 0, 1, 3, 4]]
          and torch.equal(v.view(torch.int32), vr.view(torch.int32)),
          f"topk signed zeros: {i.tolist()} {v.tolist()}")
    n0 = ops.LAUNCHES["topk"]
    v, i = ops.topk(torch.zeros(0, 1000, device=dev), 7)
    check(v.shape == (0, 7) and i.shape == (0, 7)
          and ops.LAUNCHES["topk"] == n0, "topk B = 0")
    return max(errs)


def topk_entry(ops, ref, probs, peaks):
    """``topk`` timed on one full batch of the cheap CNN's probabilities
    (the pipeline's shape and data), against its plain version and the
    library's stable descending sort (the same function: ties to the
    lowest column)."""
    import torch
    B, C = probs.shape
    k = C
    n_bytes = 4 * B * C + 8 * B * k
    return {
        "shape": [B, C, k],
        **timings(lambda: ops.topk(probs, k), lambda: ref.topk_ref(probs, k),
                  lambda: torch.sort(probs, dim=1, descending=True,
                                     stable=True)[1][:, :k]),
        "bound_ms": 1e3 * n_bytes / peaks["bytes"], "bound_by": "bytes",
    }


def _gate_pair(ops, ref, f, bg, alpha, thr, tile):
    """The kernel and its plain version on the same card-resident inputs:
    new_bg, tiles and hot must be bitwise equal."""
    import torch
    got = ops.motion_gate(f, bg, alpha, thr, tile=tile)
    want = ref.motion_gate_ref(f, bg, alpha, thr, tile)
    torch.cuda.synchronize()
    for name, a, b in zip(("new_bg", "tiles", "hot"), got, want):
        check(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b),
              f"motion_gate {name} differs from the plain version at "
              f"{tuple(f.shape)}, tile {tile}, alpha {alpha}, thr {thr}")
    return got


def check_motion_gate(ops, ref, dev, frames):
    """``motion_gate`` against its plain version, bitwise: two consecutive
    frames of the stream (the path's 128 x 128, tile 8), a 720p frame,
    ragged shapes, a frame smaller than one tile (a launch, the EMA only),
    a static frame (cold), a tile mean exactly at the threshold (cold)
    and just above it (hot), alpha = 0 and alpha = 1. Returns the
    card-resident path inputs and a 720p pair for timing."""
    import numpy as np
    import torch
    r = np.random.default_rng(4)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    path = (t(frames[1]), t(frames[0]))
    _, _, hot = _gate_pair(ops, ref, *path, 0.05, 0.08, 8)
    cases = {"path_hot_tiles": int(hot.sum())}
    for H, W, tile in ((720, 1280, 8), (70, 51, 8), (33, 95, 8),
                       (16, 24, 4), (4, 20, 8)):
        f = r.random((H, W, 3), dtype=np.float32)
        bg = f + r.normal(0, 0.1, (H, W, 3))
        n0 = ops.LAUNCHES["motion_gate"]
        _, tiles, hot = _gate_pair(ops, ref, t(f), t(bg), 0.05, 0.08, tile)
        check(ops.LAUNCHES["motion_gate"] == n0 + 1, "motion_gate launch")
        check(tuple(tiles.shape) == (H // tile, W // tile), "tile grid")
        cases[f"{H}x{W}_t{tile}_hot"] = int(hot.sum())
        if H == 720:
            big = (t(f), t(bg))
    _, tiles, hot = _gate_pair(ops, ref, path[0], path[0], 0.05, 0.0, 8)
    check(bool((tiles == 0).all()) and not hot.any(), "static frame is hot")
    z = torch.zeros(16, 16, 3, device=dev)
    half = torch.full((16, 16, 3), 0.5, device=dev)
    _, tiles, hot = _gate_pair(ops, ref, z, half, 0.05, 0.5, 8)
    check(bool((tiles == 0.5).all()) and not hot.any(),
          "a tile mean exactly at the threshold must stay cold")
    _, _, hot = _gate_pair(ops, ref, z, half, 0.05, 0.4999, 8)
    check(bool(hot.all()), "a tile mean above the threshold must be hot")
    nb, _, _ = _gate_pair(ops, ref, *path, 0.0, 0.08, 8)
    check(torch.equal(nb, path[1]), "alpha = 0 must keep the background")
    nb, _, _ = _gate_pair(ops, ref, *path, 1.0, 0.08, 8)
    check(torch.equal(nb, path[0]), "alpha = 1 must take the frame")
    return cases, path, big


def _gate_frames_pair(ops, ref, fr, bg, alpha, thr, tile):
    """The window kernel (one launch) and its plain version on the same
    card-resident inputs: new_bg, tiles and hot must be bitwise equal."""
    import torch
    n0 = ops.LAUNCHES["motion_gate"]
    got = ops.motion_gate_frames(fr, bg, alpha, thr, tile=tile)
    check(ops.LAUNCHES["motion_gate"] == n0 + 1,
          "motion_gate_frames must launch once per call")
    want = ref.motion_gate_frames_ref(fr, bg, alpha, thr, tile)
    torch.cuda.synchronize()
    for name, a, b in zip(("new_bg", "tiles", "hot"), got, want):
        check(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b),
              f"motion_gate_frames {name} differs from the plain version at "
              f"{tuple(fr.shape)}, tile {tile}, alpha {alpha}, thr {thr}")
    return got


def check_motion_gate_frames(ops, ref, dev, frames, window, window_720p):
    """``motion_gate_frames`` against its plain version, bitwise, one launch
    per call: a window of the stream's frames as background subtraction
    gates it (128 x 128, tile 8, ``window`` frames after the seed frame),
    a 720p window, ragged shapes (remainder rows and columns, groups of 1
    to 128 threads per tile, tiles too large for registers, frames smaller
    than a tile), a window of one, static frames (cold), a tile mean
    exactly at the threshold (cold) and just above it (hot), alpha 0 and
    alpha 1. Returns the path's window and a 720p window for timing."""
    import numpy as np
    import torch
    r = np.random.default_rng(5)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    seed_bg = t(frames[0])
    path = (t(np.stack(frames[1:window + 1])), seed_bg)
    _, _, hot = _gate_frames_pair(ops, ref, *path, 0.05, 0.08, 8)
    cases = {"path_window": [int(path[0].shape[0]), int(hot.sum())]}
    for N, H, W, tile in ((window_720p, 720, 1280, 8), (9, 70, 51, 8),
                          (17, 33, 95, 8), (3, 16, 24, 4), (11, 130, 70, 3),
                          (4, 128, 128, 16), (5, 64, 64, 1),
                          (3, 90, 100, 30), (4, 4, 20, 8)):
        fr = r.random((N, H, W, 3), dtype=np.float32)
        bg = fr[0] + r.normal(0, 0.1, (H, W, 3))
        _, tiles, hot = _gate_frames_pair(ops, ref, t(fr), t(bg), 0.05, 0.08,
                                          tile)
        check(tuple(tiles.shape) == (N, H // tile, W // tile), "tile grid")
        cases[f"{N}x{H}x{W}_t{tile}_hot"] = int(hot.sum())
        if H == 720:
            big = (t(fr), t(bg))
    _gate_frames_pair(ops, ref, path[0][:1], seed_bg, 0.05, 0.08, 8)
    static = seed_bg[None].repeat(4, 1, 1, 1).contiguous()
    _, tiles, hot = _gate_frames_pair(ops, ref, static, seed_bg, 0.5, 0.0, 8)
    check(bool((tiles == 0).all()) and not hot.any(), "static frames are hot")
    z = torch.zeros(3, 16, 16, 3, device=dev)
    half = torch.full((16, 16, 3), 0.5, device=dev)
    _, tiles, hot = _gate_frames_pair(ops, ref, z, half, 0.0, 0.5, 8)
    check(bool((tiles == 0.5).all()) and not hot.any(),
          "a window's tile mean exactly at the threshold must stay cold")
    _, _, hot = _gate_frames_pair(ops, ref, z, half, 0.0, 0.4999, 8)
    check(bool(hot.all()), "a window's tile mean above the threshold")
    few = path[0][:16]
    nb, _, _ = _gate_frames_pair(ops, ref, few, seed_bg, 0.0, 0.08, 8)
    check(torch.equal(nb, seed_bg), "alpha = 0 must keep the background")
    nb, _, _ = _gate_frames_pair(ops, ref, few, seed_bg, 1.0, 0.08, 8)
    check(torch.equal(nb, few[-1]), "alpha = 1 must take the last frame")
    return cases, path, big


def gate_frames_entry(ops, ref, fr, bg, peaks, tile=8):
    """``motion_gate_frames`` timed on one window; bound by bytes: the N
    frames read once, bg read and new_bg written once, and N masks (fp32
    tile means and bool hot flags). The plain version loops over the
    frames, so it is timed over 2 calls."""
    N, H, W = fr.shape[:3]
    n_tiles = (H // tile) * (W // tile)
    n_bytes = (N + 2) * H * W * 3 * 4 + N * n_tiles * 5
    out = {
        "shape": [N, H, W, 3], "tile": tile,
        **timings(lambda: ops.motion_gate_frames(fr, bg, 0.05, 0.08,
                                                 tile=tile),
                  lambda: ref.motion_gate_frames_ref(fr, bg, 0.05, 0.08,
                                                     tile),
                  plain_iters=2),
        "bound_ms": 1e3 * n_bytes / peaks["bytes"], "bound_by": "bytes",
    }
    for key in ("ms", "device_ms", "bound_ms"):
        out[f"{key}_per_frame"] = out[key] / N
    return out


def gate_entry(ops, ref, f, bg, peaks, tile=8):
    """``motion_gate`` timed at one shape; bound by bytes: frame and bg
    read once, new_bg written once, plus the tile outputs."""
    H, W = f.shape[:2]
    n_tiles = (H // tile) * (W // tile)
    n_bytes = 3 * H * W * 3 * 4 + n_tiles * 5
    return {
        "shape": [H, W, 3], "tile": tile,
        **timings(lambda: ops.motion_gate(f, bg, 0.05, 0.08, tile=tile),
                  lambda: ref.motion_gate_ref(f, bg, 0.05, 0.08, tile)),
        "bound_ms": 1e3 * n_bytes / peaks["bytes"], "bound_by": "bytes",
    }


def kernel_phase(ops, ref, dev, crops, probs, peaks):
    import numpy as np
    import torch
    from repro_torch.hopper import build
    fa_checks, fa_path = check_flash_attention(ops, ref, dev, lm_config())
    ca_err, (f, c, T) = check_centroid_assign(ops, ref, dev)
    pm_err, tracker, gate, _ = check_pixel_match(ops, ref, dev, crops)
    dq_err = check_dequant_topk(ops, ref, dev)
    tk_err = check_topk(ops, ref, dev, probs)
    from repro_torch.data.bgsub import BackgroundSubtractor
    it = iter(get_frames("jacksonh"))
    stream_frames = [next(it)]
    window = BackgroundSubtractor.WINDOW_BYTES // stream_frames[0].nbytes
    stream_frames += [next(it) for _ in range(window)]
    window_720p = BackgroundSubtractor.WINDOW_BYTES // (720 * 1280 * 3 * 4)
    gate_cases, gate_path, gate_big = check_motion_gate(
        ops, ref, dev, stream_frames[:2])
    win_cases, win_path, win_720p = check_motion_gate_frames(
        ops, ref, dev, stream_frames, window, window_720p)
    del stream_frames

    def ca_entry(f, c):
        B, D = f.shape
        M = c.shape[0]
        ca_bytes = (B * D + M * D) * 4 + B * 9
        ca_ops = 2 * B * M * D
        out = {"shape": [B, M, D],
               "blocks": build.load().centroid_assign_blocks(B, M),
               **timings(lambda: ops.centroid_assign(f, c, threshold=T),
                         lambda: ref.centroid_assign_ref(f, c, T),
                         lambda: torch.cdist(f, c).pow(2).min(1)),
               "bound_ms": 1e3 * max(ca_ops / peaks["fp32"],
                                     ca_bytes / peaks["bytes"]),
               "bound_by": ("operations" if ca_ops / peaks["fp32"]
                            > ca_bytes / peaks["bytes"] else "bytes")}
        out["device_tflops"] = ca_ops / out["device_ms"] / 1e9
        return out

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ca = {"name": "centroid_assign", "route": "cuda",
          "design": "SIMT fp32 register tiles 64x128 (8x4 a thread), "
                    "k-steps of 16 double-buffered, argmin keys merged "
                    "by atomicMin, last block per row tile finishes",
          "source": "src/repro_torch/hopper/csrc/centroid_assign.cu",
          "replaces": "src/repro/kernels/centroid_assign.py:89",
          "max_abs_err": ca_err, "sms": sms, **ca_entry(f, c)}
    check(ca["blocks"] >= sms, f"centroid_assign runs {ca['blocks']} "
          f"blocks on {sms} SMs")
    ca_2048 = {"name": "centroid_assign", **ca_entry(f, c[:2048])}
    stacked_err, ca_stacked = check_centroid_assign_stacked(ops, ref, dev,
                                                            peaks)
    ca["max_abs_err"] = max(ca["max_abs_err"], stacked_err)
    ca["stacked"] = {"path_shape": "the multi-stream step: 8 stream slots "
                     "in one launch", **ca_stacked}

    def pm_entry(a, b, lo=None, hi=None):
        """Timed at one shape; the bound counts the pairs these ranges
        hold and each row of the buffer read once."""
        Na, Dp = a.shape
        Nb = b.shape[0]
        if lo is None:
            pairs, n_rows = Na * Nb, Na + Nb
            kernel = lambda: ops.pixel_match(a, b, 0.02)        # noqa: E731
            plain = lambda: ref.pixel_match_ref(a, b, 0.02)     # noqa: E731
            library = lambda: (torch.cdist(a, b, p=1) / Dp).min(1)  # noqa
        else:
            pairs = int((hi - lo).clamp(min=0).sum())
            shared = (a.untyped_storage().data_ptr()
                      == b.untyped_storage().data_ptr())
            n_rows = Nb if shared else Na + Nb
            kernel = lambda: ops.pixel_match_ranges(a, b, lo, hi, 0.02)  # noqa
            plain = lambda: ref.pixel_match_ranges_ref(a, b, lo, hi, 0.02)  # noqa
            library = None      # no one PyTorch call matches per range
        n = pairs * Dp
        # per element: an fp32 subtract and abs, an fp64 add
        op_s = n * (2 / peaks["fp32"] + 1 / peaks["fp64"])
        by_s = (n_rows * Dp * 4 + Na * 8
                + (0 if lo is None else 8 * Na)) / peaks["bytes"]
        return {
            "shape": [Na, Nb, Dp], "pairs": pairs,
            **timings(kernel, plain, library,
                      plain_iters=50 if lo is None else 3),
            "bound_ms": 1e3 * max(op_s, by_s),
            "bound_by": "operations" if op_s > by_s else "bytes",
        }

    from repro_torch.data.video import get_stream
    crops_120, frames_120 = get_stream("jacksonh", duration_s=120,
                                       fps=30).objects_array()[:2]
    window = tracker_window(crops_120, frames_120, dev)
    pm = {"name": "pixel_match", "route": "cuda",
          "design": "a warp per pair, 16-byte loads, fp64 sums, a range "
                    "per row; one launch per tracker window, long ranges "
                    "split and merged in the launch by atomicMin",
          "source": "src/repro_torch/hopper/csrc/pixel_diff.cu",
          "replaces": "src/repro/kernels/pixel_diff.py:77",
          "max_abs_err": pm_err, "path_shape": "tracker window, 120 s "
          "one-shot", **pm_entry(*window)}
    pm_gate = {"name": "pixel_match", **pm_entry(*gate)}
    pm_frame = {"name": "pixel_match", "path_shape": "one frame pair "
                "(a per-frame tracker's call)", **pm_entry(*tracker)}
    del window
    dq = {"name": "dequant_topk", "route": "cuda",
          "design": "a block per row, one stable counting pass over the "
                    "8-bit key: equal-valued keys merged into groups, "
                    "match_any ranks within warps, a scan over 256 groups",
          "source": "src/repro_torch/hopper/csrc/dequant_topk.cu",
          "replaces": "src/repro/kernels/dequant_topk.py:56",
          "max_abs_err": dq_err}
    tk = {"name": "topk", "route": "cuda",
          "design": "bitonic sort, 64-bit (value, column) keys, a block "
                    "per row, shuffles below stride 32",
          "source": "src/repro_torch/hopper/csrc/topk.cu",
          "replaces": "src/repro/kernels/topk_mask.py:42",
          "max_abs_err": tk_err, **topk_entry(ops, ref, probs, peaks)}
    mg = {"name": "motion_gate", "route": "cuda",
          "design": "one launch per window of frames: a group of threads "
                    "per tile, its values' background in registers across "
                    "the window, 8 frames of loads in flight, fp64 tile "
                    "sums by shuffle tree",
          "source": "src/repro_torch/hopper/csrc/motion_gate.cu",
          "replaces": "src/repro/kernels/frame_gate.py:51",
          "max_abs_err": 0.0, "path_shape": "a window of background "
          "subtraction's 120 s path", "cases": win_cases,
          **gate_frames_entry(ops, ref, *win_path, peaks)}
    mg_frame = {"name": "motion_gate", "cases": gate_cases,
                "path_shape": "one frame (the per-frame call)",
                **gate_entry(ops, ref, *gate_path, peaks)}
    mg_720p = {"name": "motion_gate", "path_shape": "one 720p frame",
               **gate_entry(ops, ref, *gate_big, peaks)}
    mg_720p_window = {"name": "motion_gate", "path_shape": "a 720p window",
                      **gate_frames_entry(ops, ref, *win_720p, peaks)}
    del win_path, win_720p
    fa = {"name": "flash_attention", "route": "cuda",
          "design": "bf16: mma.sync m16n8k16, p split hi/lo, cp.async x2, "
                    "64-row tiles; fp32: SIMT",
          "source": "src/repro_torch/hopper/csrc/flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention.py:78",
          **fa_checks, **flash_entry(ops, ref, *fa_path, peaks)}
    extra = {"centroid_assign_default_serve_shape": ca_2048,
             "pixel_match_gate_shape": pm_gate,
             "pixel_match_frame_shape": pm_frame,
             "motion_gate_frame_shape": mg_frame,
             "motion_gate_720p": mg_720p,
             "motion_gate_720p_window": mg_720p_window}
    return ca, pm, dq, tk, mg, fa, extra


def lm_config(**overrides):
    """The LM of the path (``LM_ARCH``'s config), with ``overrides``."""
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(LM_ARCH), **overrides)


def _flash_pair(ops, ref, q, k, v, causal, atol, rtol=0.0):
    """The kernel against its plain version on one input; every element
    within ``atol + rtol * |plain|`` (numpy's allclose)."""
    import torch
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"flash_attention output {got.dtype} {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs()
    check(not bool(bad.any()), f"flash_attention {tuple(q.shape)} "
          f"{q.dtype} causal={causal}: {int(bad.sum())} elements off, "
          f"max |diff| {float(diff.max())}")
    return float(diff.max())


def check_flash_attention(ops, ref, dev, cfg):
    """``flash_attention`` against its plain version at the JAX package's
    fp32 tolerance (``tests/test_kernels.py``), atol = rtol = 2e-5, and in
    bf16 to one ulp, rtol 2**-7 with atol 1e-4 (both round one fp32 result
    to bf16 once; those differ by the order of the sums and by the
    kernel's split of p into two bf16 terms, about 2**-17 of p); at the
    LM path's shape in both types, ragged S, every built head width,
    causal and full; and one grouped-KV layer through
    ``layers.multihead_attention``'s flash route against its einsum route
    (atol 1e-4, the JAX package's tolerance for that comparison)."""
    import numpy as np
    import torch
    from repro_torch.common import prng
    from repro_torch.models import layers
    r = np.random.default_rng(5)

    def t(shape, dtype=torch.float32):
        return torch.from_numpy(r.normal(size=shape).astype(
            np.float32)).to(dev, dtype)

    B, S, H, dh = LM_BATCH, LM_SEQ, cfg.n_heads, cfg.head_dim
    path = [t((B, S, H, dh), torch.bfloat16) for _ in range(3)]
    bf16 = [_flash_pair(ops, ref, *path, True, 1e-4, 2 ** -7)]
    bf16.append(_flash_pair(ops, ref, *(t((2, 77, H, dh), torch.bfloat16)
                                        for _ in range(3)), False, 1e-4,
                            2 ** -7))
    for d_ in (16, 32, 64):             # every head width, ragged tiles
        for s_, causal in ((129, True), (65, False), (1, True)):
            bf16.append(_flash_pair(ops, ref, *(t((2, s_, 3, d_),
                                                  torch.bfloat16)
                                                for _ in range(3)),
                                    causal, 1e-4, 2 ** -7))
    fp32 = [_flash_pair(ops, ref, *(x.float() for x in path), True, 2e-5,
                        2e-5)]
    shapes = [(2, s, 3, 64, True) for s in (1, 50, 1000)]
    shapes += [(2, 130, 3, d, c) for d in (16, 32, 64)
               for c in (True, False)]
    shapes += [(2, 96, 3, 128, False)]
    for b_, s_, h_, d_, causal in shapes:
        fp32.append(_flash_pair(ops, ref, *(t((b_, s_, h_, d_))
                                            for _ in range(3)),
                                causal, 2e-5, 2e-5))
    # grouped KV: 4 query heads per KV head at the LM's width
    D, n_heads = cfg.d_model, cfg.n_heads
    p = layers.attn_init(prng.key(9, dev), D, n_heads, n_heads // 4,
                         torch.float32)
    x = t((2, 300, D))
    kw = dict(n_heads=n_heads, n_kv_heads=n_heads // 4, causal=True)
    got = layers.multihead_attention(p, x, attn_impl="flash", **kw)
    want = layers.multihead_attention(p, x, attn_impl="einsum", **kw)
    gqa = float((got - want).abs().max())
    check(gqa <= 1e-4, f"grouped-KV flash route vs einsum route: {gqa}")
    return {"max_abs_err": max(fp32), "bf16_max_abs_err": max(bf16),
            "gqa_max_abs_err": gqa, "cases": len(fp32) + len(bf16) + 1}, \
        path


def flash_entry(ops, ref, q, k, v, peaks):
    """``flash_attention`` timed at the LM path's shape (causal bf16).
    Bound by operations: the causal half of the two products, S(S+1)/2
    score pairs per head at 2*dh operations each per product. q.k^T has
    bf16 operands; p.v has fp32 p (the JAX kernel keeps it fp32), which is
    p_hi + p_lo, two bf16 terms, against bf16 v: so all of it runs on the
    bf16 tensor cores, q.k^T once and p.v twice (``tensor_gflop``). Bytes:
    q, k, v read once, the output written once. Beside it, the bound with
    p.v at fp32's peak (``bound_p_fp32_ms``, the bound before the split);
    ``tensor_tflops`` is the tensor work over the kernel's time. SDPA on
    the (B, H, S, dh) view is the library yardstick, never called by the
    port."""
    import torch
    import torch.nn.functional as F
    B, S, H, dh = q.shape
    check(q.dtype == torch.bfloat16, "flash_entry times the bf16 path")
    n_ops = 2 * B * H * dh * S * (S + 1)
    tensor_ops = n_ops / 2 + 2 * n_ops / 2
    n_bytes = 4 * q.numel() * q.element_size()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    op_s = tensor_ops / peaks["bf16_tc"]
    by_s = n_bytes / peaks["bytes"]
    t = timings(lambda: ops.flash_attention(q, k, v, causal=True),
                lambda: ref.flash_attention_ref(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
    return {
        "shape": [B, S, H, dh], "dtype": str(q.dtype), "causal": True,
        "gflop": n_ops / 1e9, "tensor_gflop": tensor_ops / 1e9,
        "mbytes": n_bytes / 1e6, **t,
        "tensor_tflops": tensor_ops / t["ms"] / 1e9,
        "bound_ms": 1e3 * max(op_s, by_s),
        "bound_by": "operations" if op_s > by_s else "bytes",
        "bound_p_fp32_ms": 1e3 * max(n_ops / 2 / peaks["bf16_tc"]
                                     + n_ops / 2 / peaks["fp32"], by_s),
    }



def get_frames(stream, n=None, duration=120):
    """The stream's full frames (128 x 128 x 3), generated lazily."""
    from repro_torch.data.video import get_stream
    return get_stream(stream, duration_s=duration, fps=30).frames(
        max_frames=n)


def tracker_turns(ops, dev, duration=120):
    """The §4.2 tracker over the same stream two ways, in turns per-frame,
    batched, batched, per-frame: one ``ops.pixel_match`` call per frame
    with objects (its crops and the previous frame's uploaded, matched,
    read back), as a per-frame tracker runs, against
    ``pixel_tracks`` on the card (one ``pixel_match_ranges`` launch per
    window). Host wall with the card synchronised; the per-frame loop's
    uploads are timed apart inside it, and the batched path's one upload
    of the same bytes is timed alone. The roots must be identical, and
    equal to the CPU's."""
    import numpy as np
    import torch
    from repro_torch.core.ingest import pixel_tracks
    from repro_torch.core.streaming import frame_groups
    from repro_torch.data.video import get_stream

    crops, frames = get_stream("jacksonh", duration_s=duration,
                               fps=30).objects_array()[:2]
    order = np.argsort(frames, kind="stable")
    fs = frames[order]
    flat = np.ascontiguousarray(crops[order].reshape(len(fs), -1),
                                np.float32)

    def per_frame():
        roots = np.arange(len(fs))
        h2d = 0.0
        prev = None
        for f, i, j in frame_groups(fs, 0, len(fs)):
            r = order[i:j].astype(np.int64)
            if prev is not None and prev[0] == f - 1:
                t0 = time.perf_counter()
                a = torch.from_numpy(flat[i:j]).to(dev)
                b = torch.from_numpy(flat[prev[1]:prev[2]]).to(dev)
                torch.cuda.synchronize()
                h2d += time.perf_counter() - t0
                m = ops.pixel_match(a, b, 0.02)[0].cpu().numpy()
                hit = m >= 0
                r[hit] = prev[3][m[hit]]
            roots[order[i:j]] = r
            prev = (f, i, j, r)
        return roots, h2d

    def batched():
        return pixel_tracks(crops, frames, 0.02, device="cuda"), None

    runs, roots = [], {}
    for mode in ("per_frame", "batched", "batched", "per_frame"):
        fn = per_frame if mode == "per_frame" else batched
        n0 = ops.LAUNCHES["pixel_match"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, h2d = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if h2d is None:                 # the same bytes, uploaded alone
            t1 = time.perf_counter()
            torch.from_numpy(flat).to(dev)
            torch.cuda.synchronize()
            h2d = time.perf_counter() - t1
        roots.setdefault(mode, got)
        check(np.array_equal(got, roots[mode]), f"{mode} roots moved")
        runs.append({"mode": mode, "wall_s": wall, "h2d_s": h2d,
                     "launches": ops.LAUNCHES["pixel_match"] - n0})
    check(np.array_equal(roots["per_frame"], roots["batched"]),
          "batched and per-frame tracker roots differ")
    check(np.array_equal(roots["batched"],
                         pixel_tracks(crops, frames, 0.02, device="cpu")),
          "card and CPU tracker roots differ")
    # jacksonh's duplicates sit just above 0.02 (ROADMAP C1), so few or no
    # crops track at the path's threshold: hold the two tracker paths and
    # the CPU to each other where many do
    loose = {dev_: pixel_tracks(crops, frames, 0.03, device=dev_)
             for dev_ in ("cuda", "cpu")}
    check(np.array_equal(loose["cuda"], loose["cpu"]),
          "card and CPU tracker roots differ at 0.03")
    tracked_loose = int((loose["cpu"] != np.arange(len(fs))).sum())
    check(tracked_loose > 0, "nothing tracks at 0.03")
    return {"duration_s": duration, "objects": int(len(fs)),
            "frames_with_objects": int(len(np.unique(fs))),
            "crop_mbytes": flat.nbytes / 1e6,
            "tracked": int((roots["batched"] != np.arange(len(fs))).sum()),
            "tracked_at_0.03": tracked_loose,
            "roots_identical": True, "runs": runs}


# ---------------------------------------------------------------------------
# phase 3: the default serve path and background subtraction
# ---------------------------------------------------------------------------

def default_report(report):
    """The default path's own checks and figures: every logged loss finite
    and each model's last logged loss below its first."""
    import math
    sel = report["selection"]
    check(sel is not None, "the default path did not select")
    models = {}
    for mid, m in sel["models"].items():
        hist = m["history"]
        check(m["train_s"] is not None and len(hist) >= 2,
              f"{mid} was not trained in this run")
        check(all(math.isfinite(h["loss"]) for h in hist),
              f"{mid}: a logged loss is not finite")
        check(hist[-1]["loss"] < hist[0]["loss"],
              f"{mid}: the last logged loss is not below the first")
        models[mid] = {"train_s": m["train_s"], "steps": hist[-1]["step"],
                       "first": {k: hist[0][k] for k in ("loss", "acc")},
                       "last": {k: hist[-1][k] for k in ("loss", "acc")}}
    walls = [r["wall_s"] for r in report["rounds"]]
    return {"models": models, "sweep_s": sel["sweep_s"],
            "choice": sel["choice"], "cold_round_s": walls[0],
            "warm_round_s": walls[1:]}


def bgsub_path(ops, duration=120):
    """§6.1 background subtraction on the card over the stream's full
    frames, in turns per-frame, windowed, windowed, per-frame, each with a
    fresh ``BackgroundSubtractor(device="cuda")`` and its launch counters
    zeroed just before it and read just after: per frame, one
    ``motion_gate`` launch per frame after the first (``__call__``);
    windowed, one ``motion_gate_frames`` launch per window (``process``).
    Each stage is timed with the card synchronised around it: upload,
    kernel, mask read (the step less the kernel), components, and the
    rest of the wall (``other``: stacking a window, the Python around).
    Boxes and background must be identical in all four turns; crops are
    cut for every box. Returns the report, the boxes of every frame and
    the final background."""
    import numpy as np
    import torch
    from repro_torch.data import bgsub
    from repro_torch.data.video import get_stream

    vs = get_stream("jacksonh", duration_s=duration, fps=30)
    n_frames = vs.cfg.n_frames
    visible = np.zeros(n_frames, np.int64)
    for tr in vs._tracks:
        visible[tr.t0:min(tr.t1, n_frames)] += 1
    frames = list(vs.frames())
    check(len(frames) == n_frames, "frame count")
    window = bgsub.BackgroundSubtractor.WINDOW_BYTES // frames[0].nbytes
    turns, first = [], None
    for mode in ("per_frame", "windowed", "windowed", "per_frame"):
        bs = bgsub.BackgroundSubtractor(device="cuda")
        spent = {"upload": 0.0, "kernel": 0.0, "step": 0.0,
                 "components": 0.0}
        timed = stage_timer(spent, {})
        name = "motion_gate" if mode == "per_frame" else "motion_gate_frames"
        kernel = getattr(ops, name)
        bs._upload = timed("upload", bs._upload)
        bs._step = timed("step", bs._step)
        bs._steps = timed("step", bs._steps)
        bs._components = timed("components", bs._components)
        ops.reset_launches()
        setattr(ops, name, timed("kernel", kernel))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            boxes = ([bs(f) for f in frames] if mode == "per_frame"
                     else bs.process(frames))
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            setattr(ops, name, kernel)
        launches = dict(ops.LAUNCHES)
        bg = bs.background
        if first is None:
            first = (boxes, bg)
        check(boxes == first[0], f"{mode} boxes differ from the first turn")
        check(np.array_equal(bg, first[1]),
              f"{mode} background differs from the first turn")
        n = launches["motion_gate"]
        if mode == "per_frame":
            check(n == n_frames - 1, f"motion_gate launched {n} times for "
                  f"{n_frames} frames, one per frame after the first")
        else:
            check(0 < n <= -(-(n_frames - 1) // window) + 1,
                  f"motion_gate launched {n} times for {n_frames} frames "
                  f"in windows of {window}")
        ms = {k: 1e3 * v / (n_frames - 1) for k, v in spent.items()}
        ms["mask_read"] = ms.pop("step") - ms["kernel"]
        ms["total"] = 1e3 * total / (n_frames - 1)
        ms["other"] = ms["total"] - sum(ms[k] for k in (
            "upload", "kernel", "mask_read", "components"))
        turns.append({"mode": mode, "launches": n, "ms_per_frame": ms})
    boxes, bg = first
    n_crops = 0
    for frame, b in zip(frames, boxes):
        crops = bgsub.extract_crops(frame, b, vs.cfg.obj_res)
        check(crops.shape == (len(b), 32, 32, 3) and (
            crops.dtype == np.float32), f"crops {crops.shape}")
        n_crops += len(crops)
    with_box = np.array([len(b) > 0 for b in boxes])
    return {
        "duration_s": duration, "frames": n_frames,
        "frame_shape": [vs.cfg.frame_res, vs.cfg.frame_res, 3],
        "window_frames": int(window), "turns": turns,
        "boxes_identical": True, "background_bitwise": True,
        "boxes": int(sum(len(b) for b in boxes)), "crops": n_crops,
        "frames_with_box": int(with_box.sum()),
        "frames_with_visible_track": int((visible > 0).sum()),
        "frames_with_both": int((with_box & (visible > 0)).sum()),
    }, boxes, bg


# ---------------------------------------------------------------------------
# phase 3: the fused ingest pipeline
# ---------------------------------------------------------------------------

def _pipeline_ingest(forward, cfg, crops, frames, flops, mode, sink=None):
    """One ingest of ``crops`` on the card, staged (``staged_cheap_apply``)
    or through the fused pipeline; returns the ingestor's results, the
    pipeline (None when staged) and the host wall time."""
    import torch
    from repro_torch.core.ingest import ingest
    from repro_torch.core.pipeline import IngestPipeline, staged_cheap_apply
    pipe = (IngestPipeline(forward, cfg, topk_sink=sink)
            if mode == "pipeline" else None)
    apply = staged_cheap_apply(forward, cfg) if pipe is None else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index, stats = ingest(crops, frames, apply, flops, cfg,
                          n_local_classes=1000, device="cuda",
                          pipeline=pipe)
    torch.cuda.synchronize()
    return index, stats, pipe, time.perf_counter() - t0


def pipeline_path(ops, forward, mcfg, serve_args, duration):
    """The fused pipeline against the staged path on the same stream, in
    turns staged, pipeline, pipeline, staged; the first pipeline run is
    the one whose launches are counted. Every index must save the same
    bytes, and the sink must hold every CNN'd object once."""
    import numpy as np
    from repro_torch.core.ingest import IngestConfig
    from repro_torch.data.video import get_stream

    crops, frames = get_stream("jacksonh", duration_s=duration,
                               fps=30).objects_array()[:2]
    # the config launch/serve.py builds for its one-shot ingest
    cfg = IngestConfig(K=serve_args["K"], threshold=serve_args["T"])
    flops = mcfg.flops_per_image()
    sunk = []

    def sink(objs, vals, idxs):
        if not sunk:                    # the first batch: full rankings
            check((np.diff(vals, axis=1) <= 0).all()
                  and (np.sort(idxs, axis=1) == np.arange(idxs.shape[1])
                       ).all(), "the sink's first batch is not a ranking")
        sunk.append(np.array(objs))

    runs, launches = [], None
    for i, mode in enumerate(("staged", "pipeline", "pipeline", "staged")):
        if i == 1:
            ops.reset_launches()
        index, stats, pipe, wall = _pipeline_ingest(
            forward, cfg, crops, frames, flops, mode,
            sink=sink if i == 1 else None)
        if i == 1:
            launches = dict(ops.LAUNCHES)
            counted = (stats, pipe)
        runs.append({"mode": mode, "wall_s": wall,
                     "objects_per_s": len(crops) / wall,
                     "bytes": index.save_bytes(),
                     "clusters": index.n_clusters})
    want = runs[0]["bytes"]
    check(all(r.pop("bytes") == want for r in runs),
          "pipeline and staged indexes differ on the card")
    stats, pipe = counted
    check(all(launches[k] > 0 for k in ("centroid_assign", "pixel_match",
                                        "topk")),
          f"a kernel of the pipeline path never launched: {launches}")
    check(launches["topk"] == pipe.stats.n_batches,
          f"topk launched {launches['topk']} times for "
          f"{pipe.stats.n_batches} megasteps")
    objs = np.concatenate(sunk)
    check(len(objs) == stats.n_cnn_invocations == len(np.unique(objs)),
          "the sink does not hold every CNN'd object once")
    check(pipe.stats.dispatches_per_batch <= 2.0, "over 2 dispatches/batch")
    rate = {m: [r["objects_per_s"] for r in runs if r["mode"] == m]
            for m in ("staged", "pipeline")}
    return {
        "duration_s": duration, "objects": int(len(crops)),
        "cnn": stats.n_cnn_invocations, "launches": launches,
        "runs": runs, "bytes_identical": True,
        "staged_objects_per_s_mean": float(np.mean(rate["staged"])),
        "pipeline_objects_per_s_mean": float(np.mean(rate["pipeline"])),
        "pipeline_stats": {**vars(pipe.stats), "dispatches_per_batch":
                           pipe.stats.dispatches_per_batch},
        "rollover": pipeline_rollover(forward, cfg, flops, 120),
    }


def pipeline_rollover(forward, cfg, flops, duration, shard_objects=2048,
                      n_chunks=8):
    """Rollover through the pipeline and through the staged path, fed in
    chunks: the sealed shards and manifests must be identical."""
    import numpy as np
    import torch
    from repro_torch.core.archive import ShardCatalog
    from repro_torch.core.index import saved_file_bytes
    from repro_torch.core.pipeline import IngestPipeline, staged_cheap_apply
    from repro_torch.core.streaming import StreamingIngestor
    from repro_torch.data.video import get_stream

    crops, frames = get_stream("jacksonh", duration_s=duration,
                               fps=30).objects_array()[:2]
    bounds = np.linspace(0, len(crops), n_chunks + 1).astype(int)
    out = {"duration_s": duration, "shard_objects": shard_objects,
           "chunks": n_chunks}
    with tempfile.TemporaryDirectory() as root:
        cats = {}
        for mode in ("staged", "pipeline"):
            cats[mode] = ShardCatalog.open(os.path.join(root, mode))
            pipe = IngestPipeline(forward, cfg) if mode == "pipeline" else None
            ing = StreamingIngestor(
                None if pipe else staged_cheap_apply(forward, cfg), flops,
                cfg, n_local_classes=1000, catalog=cats[mode],
                shard_objects=shard_objects, device="cuda", pipeline=pipe)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for lo, hi in zip(bounds, bounds[1:]):
                ing.feed(crops[lo:hi], frames[lo:hi])
                ing.flush()
            ing.finish()
            torch.cuda.synchronize()
            out[f"{mode}_wall_s"] = time.perf_counter() - t0
            out[f"{mode}_ingestor_s"] = ing.stats.wall_s
        cs, cp = cats["staged"], cats["pipeline"]
        check(len(cs) > 1, "the rollover cut sealed one shard")
        check([vars(m) for m in cs] == [vars(m) for m in cp],
              "pipeline and staged manifests differ")
        for m in cs:
            check(saved_file_bytes(cs.path_of(m.shard_id))
                  == saved_file_bytes(cp.path_of(m.shard_id)),
                  f"pipeline shard {m.shard_id} differs from the staged one")
        out.update(shards=len(cs), shards_identical=True)
    return out


# ---------------------------------------------------------------------------
# phase 3: multi-stream ingest (the sharded runner on a one-card mesh)
# ---------------------------------------------------------------------------

# eight cameras of the zoo: traffic, surveillance and news
MULTI_STREAMS = ("jacksonh", "city_a_d", "auburn_c", "church_st", "sittard",
                 "cnn", "foxnews", "msnbc")


def _chunked(streams, n_chunks):
    """Round r's chunk of every stream: {name: (crops, frames)}."""
    import numpy as np
    bounds = {nm: np.linspace(0, len(c), n_chunks + 1).astype(int)
              for nm, (c, _) in streams.items()}
    return [{nm: (c[bounds[nm][r]:bounds[nm][r + 1]],
                  f[bounds[nm][r]:bounds[nm][r + 1]])
             for nm, (c, f) in streams.items()} for r in range(n_chunks)]


def _digest_sink(digests):
    """A ``topk_sink(name, objs, vals, idxs)`` hashing each stream's sunk
    rows in order (the rows of 40k objects x 1000 classes do not belong
    in host memory twice)."""
    import hashlib

    def sink(name, objs, vals, idxs):
        h = digests.setdefault(name, hashlib.sha256())
        for a in (objs, vals, idxs):
            h.update(a.tobytes())
    return sink


def _solo_pipelines(forward, cfg, flops, rounds, sink_digests):
    """Each stream through its own ``IngestPipeline`` over the same
    chunks, back to back; returns ({name: (bytes, counters)}, wall s)."""
    import torch
    from repro_torch.core.pipeline import IngestPipeline
    from repro_torch.core.streaming import StreamingIngestor
    out, wall = {}, 0.0
    for nm in rounds[0]:
        sink = _digest_sink(sink_digests)
        ing = StreamingIngestor(
            None, flops, cfg, n_local_classes=1000,
            pipeline=IngestPipeline(forward, cfg, topk_sink=lambda o, v, i,
                                    nm=nm: sink(nm, o, v, i)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for chunks in rounds:
            ing.feed(*chunks[nm])
            ing.flush()
        index, stats = ing.finish()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        out[nm] = (index.save_bytes(), vars(stats) | {"wall_s": 0})
    return out, wall


def multistream_path(ops, forward, mcfg, duration=120, n_chunks=4):
    """Eight 120 s streams through ``make_sharded_runner`` on a one-card
    ``make_ingest_mesh(1)`` with a ``topk_sink``, fed 4 chunks a stream
    per round, interleaved; launch counters zeroed just before and read
    just after. Every stream must save its solo ``IngestPipeline``'s
    bytes, counters and sink; ``centroid_assign`` and ``topk`` launch once
    per stacked step (not per stream batch), at most 2 dispatches a step.
    Then the staged ``MultiStreamRunner`` (each stream's batch forwarded
    at its solo shape) over the same streams, a rollover run on a 30 s cut
    of them (2048 objects per shard) against solo rollovers, and
    ``make_ingest_mesh(2)``'s error on a one-card machine. Records whether
    a stacked forward (8 x 512 crops) gives the solo forward's rows."""
    import numpy as np
    import torch
    from repro_torch.core.ingest import IngestConfig
    from repro_torch.core.pipeline import staged_cheap_apply
    from repro_torch.core.streaming import (MultiStreamRunner,
                                            StreamingIngestor,
                                            make_sharded_runner)
    from repro_torch.data.video import get_stream
    from repro_torch.launch.mesh import make_ingest_mesh

    # the pipeline path's config: K=1000, T=0.4, M=4096, batch 512
    cfg = IngestConfig(K=1000, threshold=0.4)
    flops = mcfg.flops_per_image()
    streams = {nm: get_stream(nm, duration_s=duration,
                              fps=30).objects_array()[:2]
               for nm in MULTI_STREAMS}
    n_objects = sum(len(c) for c, _ in streams.values())
    rounds = _chunked(streams, n_chunks)
    digests = {}
    runner = make_sharded_runner(forward, make_ingest_mesh(1),
                                 list(MULTI_STREAMS), cfg=cfg,
                                 topk_sink=_digest_sink(digests),
                                 n_local_classes=1000,
                                 cheap_flops_per_image=flops)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    for chunks in rounds:
        runner.feed(chunks)
        runner.flush()
    got = runner.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st = runner.pipeline.stats
    check(all(launches[k] > 0 for k in ("centroid_assign", "pixel_match",
                                        "topk")),
          f"a kernel of the multistream path never launched: {launches}")
    check(launches["centroid_assign"] == st.n_steps,
          f"centroid_assign launched {launches['centroid_assign']} times in "
          f"{st.n_steps} stacked steps")
    check(launches["topk"] == st.n_steps,
          f"topk launched {launches['topk']} times in {st.n_steps} steps")
    check(st.n_dispatches <= 2 * st.n_steps, "over 2 dispatches a step")
    check(st.n_batches > st.n_steps, "no step carried two streams")
    solo_digests = {}
    solo, solo_wall = _solo_pipelines(forward, cfg, flops, rounds,
                                      solo_digests)
    for nm in MULTI_STREAMS:
        index, stats = got[nm]
        check(index.save_bytes() == solo[nm][0],
              f"{nm}: the sharded index differs from the solo pipeline's")
        check(vars(stats) | {"wall_s": 0} == solo[nm][1],
              f"{nm}: IngestStats counters differ from the solo run's")
        check(digests[nm].digest() == solo_digests[nm].digest(),
              f"{nm}: the sink's top-K differs from the solo run's")
    per_stream = {nm: {"objects": len(streams[nm][0]),
                       "cnn": got[nm][1].n_cnn_invocations,
                       "clusters": got[nm][0].n_clusters,
                       "evictions": got[nm][1].n_evictions}
                  for nm in MULTI_STREAMS}
    del got

    # the staged runner: one cheap_apply, each stream's batch forwarded at
    # its solo shape; it must save the solo pipelines' bytes too
    staged = MultiStreamRunner(
        {nm: StreamingIngestor(None, flops, cfg, n_local_classes=1000)
         for nm in MULTI_STREAMS},
        cheap_apply=staged_cheap_apply(forward, cfg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for chunks in rounds:
        staged.feed(chunks)
        staged.flush()
    staged_got = staged.finish()
    torch.cuda.synchronize()
    staged_wall = time.perf_counter() - t0
    for nm, (index, _) in staged_got.items():
        check(index.save_bytes() == solo[nm][0],
              f"{nm}: the staged runner's index differs from the solo "
              f"pipeline's")
    del solo, rounds, staged_got

    # does one stacked forward (8 x 512 crops) give the solo rows here?
    x = torch.from_numpy(streams["jacksonh"][0][:8 * 512]).to(
        runner.pipeline.mesh.devices[0])
    p_all, f_all = forward(x)
    rows_equal = all(
        torch.equal(torch.cat(forward(x[i * 512:(i + 1) * 512]), 1),
                    torch.cat((p_all, f_all), 1)[i * 512:(i + 1) * 512])
        for i in range(8))
    del x, p_all, f_all, streams
    try:
        make_ingest_mesh(torch.cuda.device_count() + 1)
        raise AssertionError("make_ingest_mesh beyond the cards did not "
                             "raise")
    except ValueError as e:
        check("device='cpu'" in str(e), f"not actionable: {e}")
    return {
        "streams": list(MULTI_STREAMS), "duration_s": duration,
        "chunks_per_stream": n_chunks, "objects": n_objects,
        "launches": launches, "pipeline_stats": vars(st),
        "dispatches_per_step": st.n_dispatches / st.n_steps,
        "batches_per_step": st.n_batches / st.n_steps,
        "sharded_wall_s": wall, "sharded_objects_per_s": n_objects / wall,
        "solo_pipelines_wall_s": solo_wall,
        "solo_pipelines_objects_per_s": n_objects / solo_wall,
        "staged_runner_wall_s": staged_wall,
        "staged_runner_objects_per_s": n_objects / staged_wall,
        "bytes_identical": True, "per_stream": per_stream,
        "stacked_forward_rows_equal_solo": rows_equal,
        "mesh_error": "make_ingest_mesh(n > cards) raised ValueError",
        "rollover": multistream_rollover(forward, cfg, flops),
    }


def multistream_rollover(forward, cfg, flops, duration=30,
                         shard_objects=2048, n_chunks=4):
    """The sharded runner with a catalog per stream on a ``duration`` s cut
    of the eight streams, against each stream's solo pipeline rollover:
    manifests and every sealed shard identical."""
    import torch
    from repro_torch.core.archive import ShardCatalog
    from repro_torch.core.index import saved_file_bytes
    from repro_torch.core.pipeline import IngestPipeline
    from repro_torch.core.streaming import (StreamingIngestor,
                                            make_sharded_runner)
    from repro_torch.data.video import get_stream
    from repro_torch.launch.mesh import make_ingest_mesh

    streams = {nm: get_stream(nm, duration_s=duration,
                              fps=30).objects_array()[:2]
               for nm in MULTI_STREAMS}
    rounds = _chunked(streams, n_chunks)
    with tempfile.TemporaryDirectory() as root:
        cats = {(mode, nm): ShardCatalog.open(os.path.join(root, mode, nm))
                for mode in ("sharded", "solo") for nm in MULTI_STREAMS}
        runner = make_sharded_runner(
            forward, make_ingest_mesh(1), list(MULTI_STREAMS), cfg=cfg,
            n_local_classes=1000, cheap_flops_per_image=flops,
            ingestor_kwargs={nm: dict(catalog=cats["sharded", nm],
                                      shard_objects=shard_objects)
                             for nm in MULTI_STREAMS})
        for chunks in rounds:
            runner.feed(chunks)
            runner.flush()
        runner.finish()
        for nm in MULTI_STREAMS:
            ing = StreamingIngestor(
                None, flops, cfg, n_local_classes=1000,
                catalog=cats["solo", nm], shard_objects=shard_objects,
                pipeline=IngestPipeline(forward, cfg))
            for chunks in rounds:
                ing.feed(*chunks[nm])
                ing.flush()
            ing.finish()
        torch.cuda.synchronize()
        n_shards = {}
        for nm in MULTI_STREAMS:
            cs, cp = cats["solo", nm], cats["sharded", nm]
            check([vars(m) for m in cs] == [vars(m) for m in cp],
                  f"{nm}: sharded and solo rollover manifests differ")
            for m in cs:
                check(saved_file_bytes(cs.path_of(m.shard_id))
                      == saved_file_bytes(cp.path_of(m.shard_id)),
                      f"{nm}: sharded shard {m.shard_id} differs from the "
                      f"solo one")
            n_shards[nm] = len(cs)
    return {"duration_s": duration, "shard_objects": shard_objects,
            "chunks": n_chunks, "shards": n_shards,
            "shards_identical": True}


# ---------------------------------------------------------------------------
# phase 3: the LM serving path (prefill and KV-cache decode)
# ---------------------------------------------------------------------------

def _rel_err(a, b):
    """max |a - b| over the largest |b|: the logits' agreement."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def lm_path(ops, peaks):
    """The decoder LM served on the card: ``transformer.init`` of the path's
    config from seed 0, the prefill of ``LM_BATCH`` prompts of ``LM_SEQ``
    tokens through the flash route (one ``flash_attention`` launch per
    layer per call) and the einsum route (a warm-up, then the median wall
    of 3 calls each), and decode: a ``DECODE_PROMPT``-token prompt through
    ``decode_step`` one token at a time, then ``DECODE_NEW`` greedy
    tokens, into a ``DECODE_SLOTS``-slot cache. The launch counters are
    zeroed just before and read just after. Then the fp32 checks on the
    same weights widened to fp32: the two prefill routes' last-position
    logits, and ``decode_step`` fed the prompt against ``forward`` of the
    prompt at every position, each within 1e-4 of the largest |logit|."""
    import dataclasses
    import statistics
    import numpy as np
    import torch
    from repro_torch.common.device import resolve_device
    from repro_torch.models import transformer as T

    dev = resolve_device("cuda")
    cfg = lm_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = T.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in _flat_tree(params))
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in _flat_tree(params))
    r = np.random.default_rng(0)
    tokens = torch.from_numpy(r.integers(0, cfg.vocab_size,
                                         (LM_BATCH, LM_SEQ))).to(dev)

    PREFILL_CALLS = 4

    def run_prefill(impl, p, c):
        walls, out = [], None
        for i in range(PREFILL_CALLS):      # a warm-up, then 3 timed calls
            before = ops.LAUNCHES["flash_attention"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = T.prefill(p, tokens, c, attn_impl=impl)
            torch.cuda.synchronize()
            if i:
                walls.append(time.perf_counter() - t0)
            n = ops.LAUNCHES["flash_attention"] - before
            want = c.n_layers if impl == "flash" else 0
            check(n == want, f"{impl} prefill launched flash_attention "
                  f"{n} times, expected {want}")
        check(out.shape == (LM_BATCH, 1, c.vocab_size)
              and bool(torch.isfinite(out).all()),
              f"{impl} prefill logits {tuple(out.shape)} not finite")
        med = statistics.median(walls)
        return out, {"walls_s": walls, "median_s": med,
                     "tokens_per_s": LM_BATCH * LM_SEQ / med}

    ops.reset_launches()
    flash_logits, flash = run_prefill("flash", params, cfg)
    einsum_logits, einsum = run_prefill("einsum", params, cfg)
    cache = T.init_cache(cfg, LM_BATCH, DECODE_SLOTS, device="cuda")
    cache_bytes = sum(x.numel() * x.element_size() for x in cache.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(DECODE_PROMPT):
        logits, cache = T.decode_step(params, cache, tokens[:, t:t + 1], t,
                                      cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok, generated = logits.argmax(-1), []
    for t in range(DECODE_PROMPT, DECODE_PROMPT + DECODE_NEW):
        logits, cache = T.decode_step(params, cache, tok, t, cfg)
        tok = logits.argmax(-1)
        generated.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    check(launches["flash_attention"] == PREFILL_CALLS * cfg.n_layers
          and sum(launches.values()) == launches["flash_attention"],
          f"the LM path's launches: {launches}")
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    generated = torch.cat(generated, dim=1)
    check(generated.shape == (LM_BATCH, DECODE_NEW)
          and bool(((generated >= 0) & (generated < cfg.vocab_size)).all()),
          "greedy tokens out of the vocabulary")
    steps = DECODE_PROMPT + DECODE_NEW
    decode = {
        "batch": LM_BATCH, "cache_slots": DECODE_SLOTS,
        "prompt_tokens": DECODE_PROMPT, "new_tokens": DECODE_NEW,
        "prompt_ms_per_token": 1e3 * (t1 - t0) / DECODE_PROMPT,
        "new_ms_per_token": 1e3 * (t2 - t1) / DECODE_NEW,
        "ms_per_token": 1e3 * (t2 - t0) / steps,
        "weights_gb": weight_bytes / 1e9, "cache_gb": cache_bytes / 1e9,
        # every step reads every weight once; the einsum over the cache
        # also reads all its slots (masked past the filled ones)
        "bound_ms_weights": 1e3 * weight_bytes / peaks["bytes"],
        "bound_ms_weights_and_cache":
            1e3 * (weight_bytes + cache_bytes) / peaks["bytes"],
        "first_generated": generated[0, :8].tolist(),
    }
    bf16_routes = _rel_err(flash_logits, einsum_logits)
    del cache, logits

    # fp32 checks on the same weights (bf16 values are exact in fp32)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = T.tree_map(lambda x: x.float(), params)
    del params
    torch.cuda.empty_cache()
    fl32 = T.prefill(p32, tokens, cfg32, attn_impl="flash")
    ei32 = T.prefill(p32, tokens, cfg32, attn_impl="einsum")
    prefill_rel = _rel_err(fl32, ei32)
    check(prefill_rel <= 1e-4, f"fp32 prefill, flash vs einsum route: "
          f"{prefill_rel} of the largest |logit|")
    prompt = tokens[:, :DECODE_PROMPT]
    full, _ = T.forward(p32, prompt, cfg32)
    cache32 = T.init_cache(cfg32, LM_BATCH, DECODE_SLOTS, device="cuda")
    per_step = []
    for t in range(DECODE_PROMPT):
        out, cache32 = T.decode_step(p32, cache32, prompt[:, t:t + 1], t,
                                     cfg32)
        per_step.append(out[:, 0])
    decode_rel = _rel_err(torch.stack(per_step, dim=1), full)
    check(decode_rel <= 1e-4, f"fp32 decode vs forward: {decode_rel} of "
          f"the largest |logit|")
    del p32, cache32
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "dtype": cfg.dtype, "params": n_params,
        # the config's count also holds d for the final norm, which
        # OLMo's non-parametric LN does not have
        "config_n_params": cfg.n_params(),
        "init_s": init_s, "batch": LM_BATCH, "seq": LM_SEQ,
        "prefill_flash": flash, "prefill_einsum": einsum,
        "prefill_bf16_flash_vs_einsum_rel": bf16_routes,
        "decode": decode, "launches": launches,
        "fp32_prefill_flash_vs_einsum_rel": prefill_rel,
        "fp32_decode_vs_forward_rel": decode_rel,
    }


# ---------------------------------------------------------------------------
# phase 4: card against CPU
# ---------------------------------------------------------------------------

def lm_card_vs_cpu():
    """The LM at the path's width with ``LM_CPU_LAYERS`` layers, fp32, the
    same weights on both: the card's flash prefill and decode logits
    against the CPU's (plain versions), within 1e-4 of the largest
    |logit|; and the threefry draws on the card against the CPU's: the
    cheap CNNs' ``init_params`` and a reduced LM's ``init``, bit for
    bit."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.common.config import reduced
    from repro_torch.common.device import resolve_device
    from repro_torch.launch import zoo
    from repro_torch.models import cnn
    from repro_torch.models import transformer as T

    cfg = lm_config(n_layers=LM_CPU_LAYERS, dtype="float32")
    card = T.init(cfg, seed=1, device="cuda")
    cpu = T.tree_map(lambda x: x.cpu(), card)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (LM_CPU_BATCH, LM_CPU_SEQ))
    tp = torch.from_numpy(toks)
    tc = tp.to(resolve_device("cuda"))
    prefill_rel = _rel_err(T.prefill(card, tc, cfg, attn_impl="flash").cpu(),
                           T.prefill(cpu, tp, cfg, attn_impl="flash"))
    check(prefill_rel <= 1e-4, f"LM prefill card vs CPU: {prefill_rel}")
    n = 16
    caches = [T.init_cache(cfg, LM_CPU_BATCH, n, device=d)
              for d in ("cuda", "cpu")]
    decode_rel = 0.0
    for t in range(n):
        a, caches[0] = T.decode_step(card, caches[0], tc[:, t:t + 1], t, cfg)
        b, caches[1] = T.decode_step(cpu, caches[1], tp[:, t:t + 1], t, cfg)
        decode_rel = max(decode_rel, _rel_err(a.cpu(), b))
    check(decode_rel <= 1e-4, f"LM decode card vs CPU: {decode_rel}")
    del card, cpu, caches
    torch.cuda.empty_cache()

    cnn_cfgs = [zoo.GENERIC_FAMILY["cheap1"][0]] + [
        dataclasses.replace(c, n_classes=7)
        for c, _ in zoo.SPECIALIZED_FAMILY.values()]
    for c in cnn_cfgs:
        a, b = (cnn.init_params(c, 0, device=d) for d in ("cuda", "cpu"))
        same = all(np.array_equal(x, y) for x, y in zip(_flat_tree(a),
                                                        _flat_tree(b)))
        check(same, f"{c.name}: the card's threefry draw differs from the "
              f"CPU's")
    small = reduced(lm_config())
    a, b = (T.params_to_jax(T.init(small, 0, device=d))
            for d in ("cuda", "cpu"))
    check(all(np.array_equal(x, y) for x, y in zip(_flat_tree(a),
                                                   _flat_tree(b))),
          "the reduced LM's draw differs between the card and the CPU")
    return {"layers": cfg.n_layers, "d_model": cfg.d_model,
            "batch": LM_CPU_BATCH, "seq": LM_CPU_SEQ, "decode_steps": n,
            "prefill_rel": prefill_rel, "decode_rel": decode_rel,
            "init_draws_bitwise": [c.name for c in cnn_cfgs] + [small.name]}


def _flat_tree(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_tree(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _flat_tree(v)
    else:
        yield tree


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
    out["pipeline"] = pipeline_card_vs_cpu(crops, frames, probs, feats, row,
                                           serve_args)
    return out


def bgsub_card_vs_cpu(card_boxes, card_bg, duration=120):
    """The same frames through ``BackgroundSubtractor(device="cpu")`` (the
    plain version): the card's boxes on every frame, and its final
    background bit for bit."""
    import numpy as np
    from repro_torch.data.bgsub import BackgroundSubtractor
    bs = BackgroundSubtractor(device="cpu")
    t0 = time.perf_counter()
    n = 0
    for i, frame in enumerate(get_frames("jacksonh", duration=duration)):
        check(bs(frame) == card_boxes[i],
              f"card and CPU boxes differ at frame {i}")
        n += 1
    check(n == len(card_boxes), "frame counts differ")
    check(np.array_equal(bs.background, card_bg),
          "card and CPU backgrounds differ")
    return {"frames": n, "cpu_s": time.perf_counter() - t0,
            "boxes_identical": True, "background_bitwise": True}


def _eval_fields(e):
    c = e.candidate
    return [c.model_id, c.K, c.T, e.precision, e.recall, e.ingest_flops,
            e.query_flops, e.n_clusters, e.viable]


def selection_card_vs_cpu(duration=60, steps=150, Ls=6):
    """spec1-spec3 trained on the card on a cut of the stream, each run once
    over the cut's crops on the card; the sweep and the chosen config's
    ingest then run on the card and on the CPU over those same outputs.
    Also the trained CNNs on the CPU against the card (atol 1e-4)."""
    import numpy as np
    import torch
    from repro_torch.core.ingest import IngestConfig, ingest
    from repro_torch.core.params import select, sweep
    from repro_torch.data.video import get_stream
    from repro_torch.launch import zoo

    crops, frames, _, labels = get_stream(
        "jacksonh", duration_s=duration, fps=30).objects_array()
    row = {c.tobytes(): i for i, c in enumerate(crops)}
    models, cmaps, out = {}, {}, {"objects": int(len(crops)), "models": {}}
    with tempfile.TemporaryDirectory() as cache:
        for mid in zoo.SPECIALIZED_FAMILY:
            apply_fn, flops, cmap = zoo.get_model(
                "jacksonh", mid, crops, labels, duration, steps=steps, Ls=Ls,
                device="cuda", cache_dir=cache)
            probs, feats = apply_fn(crops)
            cpu_fn, _, _ = zoo.get_model(
                "jacksonh", mid, crops, labels, duration, steps=steps, Ls=Ls,
                device="cpu", cache_dir=cache)           # the same weights
            pc, fc = cpu_fn(crops)
            err = max(float(np.abs(probs - pc).max()),
                      float(np.abs(feats - fc).max()))
            check(err <= 1e-4, f"{mid} card vs CPU forward: {err}")
            out["models"][mid] = {"train_s": apply_fn.train_s,
                                  "cnn_max_abs_err": err}

            def lookup(batch, probs=probs, feats=feats):
                ix = np.array([row[c.tobytes()] for c in batch], np.int64)
                return probs[ix], feats[ix]
            models[mid], cmaps[mid] = (lookup, flops), cmap
    evals, choice, saved = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        evals[dev] = sweep(crops, frames, labels, models, Ks=[1, 2, 4],
                           Ts=[0.5, 0.8], gt_flops=zoo.GT_FLOPS,
                           class_maps=cmaps, max_clusters=2048, device=dev)
        torch.cuda.synchronize()
        out[f"sweep_{dev}_s"] = time.perf_counter() - t0
        choice[dev] = select(evals[dev], "balance") or max(
            evals[dev], key=lambda e: (e.recall, e.precision))
    check([_eval_fields(e) for e in evals["cuda"]]
          == [_eval_fields(e) for e in evals["cpu"]],
          "card and CPU sweeps differ")
    check(_eval_fields(choice["cuda"]) == _eval_fields(choice["cpu"]),
          "card and CPU choose differently")
    c = choice["cuda"].candidate
    cfg = IngestConfig(K=c.K, threshold=c.T, max_clusters=2048)
    for dev in ("cuda", "cpu"):
        index, _ = ingest(crops, frames, models[c.model_id][0], 0.0, cfg,
                          class_map=cmaps[c.model_id], device=dev)
        saved[dev] = index.save_bytes()
    check(saved["cuda"] == saved["cpu"],
          "the chosen config's card and CPU indexes differ")
    out.update(evals=[_eval_fields(e) for e in evals["cuda"]],
               choice=_eval_fields(choice["cuda"]), evals_identical=True,
               index_bytes_identical=True)
    return out


def train_card_vs_cpu(duration=60, steps=10, Ls=6):
    """spec1 trained ``steps`` steps on the card and on the CPU from one
    ``init=``. Two fp32 runs that sum the conv gradients in another order
    drift apart under Adam, whose update is close to sign(g) for every
    gradient above eps: the CPU against itself at one thread and at all
    threads (the floor, measured here too) differs by ~3e-3 after 10
    steps in the largest element. So the card is held to that floor with
    a margin: the largest parameter difference below 1e-2, the L2 norm of
    the difference below 5e-2 of the distance the weights moved, and each
    logged loss within 1e-3."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.specialize import estimate_distribution, specialize
    from repro_torch.data.video import get_stream
    from repro_torch.launch import zoo
    from repro_torch.models import cnn

    crops, _, _, labels = get_stream(
        "jacksonh", duration_s=duration, fps=30).objects_array()
    base = zoo.SPECIALIZED_FAMILY["spec1"][0]
    n_local = min(Ls, len(estimate_distribution(labels)[0])) + 1
    init = cnn.init_params(dataclasses.replace(base, n_classes=n_local), 7)

    def run(dev):
        sm = specialize(crops, labels, Ls=Ls, base_cfg=base, steps=steps,
                        init=init, device=dev)
        return _flat(sm.params), [h["loss"] for h in sm.history]

    threads = torch.get_num_threads()
    got = {dev: run(dev) for dev in ("cuda", "cpu")}
    torch.set_num_threads(1)
    try:
        got["cpu_1_thread"] = run("cpu")
    finally:
        torch.set_num_threads(threads)
    p0 = _flat(init)

    def compare(a, b):
        (pa, la), (pb, lb) = got[a], got[b]
        return {"max_param_diff": float(np.abs(pa - pb).max()),
                "rel_l2": float(np.linalg.norm(pa - pb)
                                / np.linalg.norm(pa - p0)),
                "max_loss_diff": float(np.abs(np.subtract(la, lb)).max())}

    out = {"steps": steps, "cpu_threads": threads,
           "max_param_moved": float(np.abs(got["cuda"][0] - p0).max()),
           "card_vs_cpu": compare("cuda", "cpu"),
           "cpu_floor": compare("cpu", "cpu_1_thread")}
    c = out["card_vs_cpu"]
    check(c["max_param_diff"] < 1e-2 and c["rel_l2"] < 5e-2
          and c["max_loss_diff"] < 1e-3,
          f"spec1 card vs CPU after {steps} steps: {c}")
    out.update(loss_cuda=got["cuda"][1], loss_cpu=got["cpu"][1])
    return out


def _flat(tree):
    """A JAX-layout parameter tree as one flat vector."""
    import numpy as np
    out = []
    for p in tree["blocks"]:
        out += [p["conv"]["w"], p["scale"], p["bias"]]
    out += [tree[k][leaf] for k in ("feat", "head") for leaf in "wb"]
    return np.concatenate([np.ravel(x) for x in out])


def pipeline_card_vs_cpu(crops, frames, probs, feats, row, serve_args):
    """The card's pipeline (``topk`` and ``centroid_assign`` kernels), the
    CPU's pipeline and the CPU's staged path, each fed the same CNN
    outputs through a lookup forward, save identical bytes; the two
    pipelines' sinks hold identical top-K."""
    import numpy as np
    import torch
    from repro_torch.common.device import resolve_device
    from repro_torch.core.ingest import IngestConfig, ingest
    from repro_torch.core.pipeline import IngestPipeline, staged_cheap_apply

    def lookup(name):
        dev = resolve_device(name)
        tp = torch.from_numpy(probs).to(dev)
        tf = torch.from_numpy(feats).to(dev)

        def forward(x):           # pad rows (zero crops) read row 0
            ix = [row.get(c.tobytes(), 0) for c in x.cpu().numpy()]
            ix = torch.tensor(ix, dtype=torch.int64, device=dev)
            return tp[ix], tf[ix]
        return forward

    out = []
    for cfg in (IngestConfig(K=serve_args["K"], threshold=serve_args["T"]),
                IngestConfig(K=serve_args["K"], threshold=serve_args["T"],
                             max_clusters=16, high_water=0.8,
                             evict_frac=0.5)):
        saved, sinks = {}, {}
        for name, dev in (("cuda", "cuda"), ("cpu", "cpu")):
            got = []
            pipe = IngestPipeline(lookup(dev), cfg, device=dev,
                                  topk_sink=lambda *a: got.append(
                                      [np.array(x) for x in a]))
            index, stats = ingest(crops, frames, None, 0.0, cfg,
                                  n_local_classes=1000, device=dev,
                                  pipeline=pipe)
            saved[name] = index.save_bytes()
            sinks[name] = [np.concatenate([g[i] for g in got])
                           for i in range(3)]
        staged, _ = ingest(crops, frames,
                           staged_cheap_apply(lookup("cpu"), cfg, "cpu"),
                           0.0, cfg, n_local_classes=1000, device="cpu")
        check(saved["cuda"] == saved["cpu"] == staged.save_bytes(),
              "pipeline indexes differ (card, CPU, CPU staged)")
        check(all((a == b).all() for a, b in zip(sinks["cuda"],
                                                 sinks["cpu"])),
              "the card's and the CPU's sinks differ")
        out.append({"max_clusters": cfg.max_clusters,
                    "evictions": stats.n_evictions,
                    "sunk_rows": int(len(sinks["cpu"][0])),
                    "bytes_identical": True, "sinks_identical": True})
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

def breakdown(apply, cfg, class_kw, duration=120):
    """Host wall time per ingest stage of ``apply`` at ``cfg`` on a cut of
    the stream, with the card synchronised around every stage so each is
    charged its own device work. Run after the other phases: the stage
    wrappers are measurement only and are removed before it returns."""
    from repro_torch.core import clustering as C
    from repro_torch.core import streaming as S
    from repro_torch.core.index import TopKIndex
    from repro_torch.core.ingest import ingest
    from repro_torch.data.video import get_stream

    crops, frames, _, _ = get_stream(
        "jacksonh", duration_s=duration, fps=30).objects_array()
    spent, calls = {}, {}
    rows = {"unmatched": 0, "padded": 0}
    timed = stage_timer(spent, calls)

    def count_rows(fn):
        def wrapper(state, sub, valid, threshold):
            rows["padded"] += len(sub)
            rows["unmatched"] += int(valid.sum())
            return fn(state, sub, valid, threshold)
        return wrapper

    stages = [(C, "_phase1", "phase1_kernel"), (C, "_fold_matched", "fold"),
              (C, "_scan_unmatched", "unmatched_scan"),
              (S, "match_ranges", "pixel_tracker"),
              (TopKIndex, "add_batch", "index_fold")]
    originals = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in stages]
    for (obj, attr, name), (_, _, fn) in zip(stages, originals):
        setattr(obj, attr, timed(name, fn))
    C._scan_unmatched = count_rows(C._scan_unmatched)
    try:
        t0 = time.perf_counter()
        index, stats = ingest(crops, frames, timed("cnn", apply), 0.0, cfg,
                              device="cuda", **class_kw)
        total = time.perf_counter() - t0
    finally:
        for obj, attr, fn in originals:
            setattr(obj, attr, fn)
    return {"duration_s": duration, "objects": int(len(crops)),
            "K": cfg.K, "T": cfg.threshold, "M": cfg.max_clusters,
            "clusters": index.n_clusters, "total_s": total,
            "stages_s": spent, "calls": calls,
            "other_s": total - sum(spent.values()), **{
                f"scan_{k}_rows": v for k, v in rows.items()}}


# background subtraction over jacksonh's first argv[2] seconds in a process
# of its own, from the ``src`` directory of the tree given first, through
# whichever API the tree has: ``process`` (a window per launch) if present,
# else one ``__call__`` per frame; a throwaway subtractor builds the
# kernels and warms the path first
COMPARE_BGSUB = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.data.bgsub import BackgroundSubtractor as BS
from repro_torch.data.video import get_stream
from repro_torch.hopper import ops
frames = list(get_stream("jacksonh", duration_s=int(sys.argv[2]),
                         fps=30).frames())
api = "process" if hasattr(BS, "process") else "per_frame"


def run(bs, fs):
    return bs.process(fs) if api == "process" else [bs(f) for f in fs]


run(BS(device="cuda"), frames[:3])
bs = BS(device="cuda")
ops.reset_launches()
torch.cuda.synchronize()
t0 = time.perf_counter()
boxes = run(bs, frames)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
flat = json.dumps([[[int(v) for v in b] for b in fb] for fb in boxes])
print(json.dumps({
    "api": api, "frames": len(frames), "wall_s": wall,
    "ms_per_frame": 1e3 * wall / (len(frames) - 1),
    "launches": ops.LAUNCHES["motion_gate"],
    "boxes_sha256": hashlib.sha256(flat.encode()).hexdigest(),
    "background_sha256": hashlib.sha256(bs.background.tobytes()).hexdigest()}))
"""

# the kernels this tree and its parent both have, timed by one method in a
# process of each tree's own (argv[1] its ``src``, argv[2] this script's
# directory): ``dequant_topk`` on a seeded (56, 1000) uint8 shard at
# k = 1000 and ``motion_gate`` on one frame at 128 x 128 and 720p, each
# device time three times with its device events per call, and the host-
# inclusive time; the window kernel where the tree has it
COMPARE_KERNELS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import numpy as np
import torch
from chip_smoke import device_profile, time_ms
from repro_torch.hopper import ops
r = np.random.default_rng(0)
dev = torch.device("cuda")
q = torch.from_numpy(r.integers(0, 256, (56, 1000)).astype(np.uint8)).to(dev)
s = torch.from_numpy((r.random(56) + 0.25).astype(np.float32)).to(dev)
calls = {"dequant_topk_56x1000_k1000": lambda: ops.dequant_topk(
    q, s, 1000, global_scale=np.float32(1 / 255))}
for H, W in ((128, 128), (720, 1280)):
    f = torch.from_numpy(r.random((H, W, 3), dtype=np.float32)).to(dev)
    b = torch.from_numpy(r.random((H, W, 3), dtype=np.float32)).to(dev)
    calls[f"motion_gate_{H}x{W}"] = (
        lambda f=f, b=b: ops.motion_gate(f, b, 0.05, 0.08, tile=8))
if hasattr(ops, "motion_gate_frames"):
    fr = torch.from_numpy(r.random((341, 128, 128, 3),
                                   dtype=np.float32)).to(dev)
    calls["motion_gate_frames_341x128x128"] = (
        lambda: ops.motion_gate_frames(fr, fr[0], 0.05, 0.08, tile=8))
out = {}
for name, fn in calls.items():
    prof = [device_profile(fn) for _ in range(3)]
    out[name] = {"device_ms": [p[0] for p in prof],
                 "device_events_per_call": [p[1] for p in prof],
                 "ms": time_ms(fn)}
print(json.dumps(out))
"""

# one served path in a process of its own, from the ``src`` directory of
# the tree given first; a fresh model cache, so every run trains alike
COMPARE_CHILD = r"""
import hashlib, json, sys, tempfile, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.core import clustering as C
from repro_torch.core import streaming as S
from repro_torch.hopper import ops
from repro_torch.launch import serve, zoo
spent = {}


def timed(name, fn):
    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return out
    return wrapper


# the tracker's matcher, whichever the tree has (per frame or per window)
for attr in ("pixel_difference", "match_ranges"):
    if hasattr(S, attr):
        setattr(S, attr, timed("pixel_tracker", getattr(S, attr)))
C._scan_unmatched = timed("unmatched_scan", C._scan_unmatched)
with tempfile.TemporaryDirectory() as cache:
    zoo.CACHE_DIR = cache
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = serve.main(json.loads(sys.argv[2]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
answers = json.dumps({str(k): [int(f) for f in v]
                      for k, v in report["answers"].items()}, sort_keys=True)
print(json.dumps({
    "wall_s": wall, "launches": dict(ops.LAUNCHES), "stages_s": spent,
    "answers_sha256": hashlib.sha256(answers.encode()).hexdigest(),
    "choice": (report.get("selection") or {}).get("choice"),
    **{k: report.get(k) for k in ("objects", "clusters", "ingest_s",
                                  "ingest_objects_per_s", "precision",
                                  "recall")}}))
"""


def _turns(code, trees, argv):
    """``code`` run by the parent tree and by this checkout in turns
    parent, change, change, parent, each in a process of its own; each
    run's last line of output, parsed."""
    runs = []
    for tree in ("parent", "change", "change", "parent"):
        out = subprocess.run(
            [sys.executable, "-c", code, trees[tree], *argv],
            capture_output=True, text=True, timeout=600)
        check(out.returncode == 0, f"{tree} failed:\n{out.stderr[-3000:]}")
        runs.append({"tree": tree, **json.loads(
            out.stdout.strip().splitlines()[-1])})
    return runs


def compare(parent_root, smi):
    """The default serve (120 s), the 600 s one-shot override path and
    background subtraction over 120 s, each run by the parent tree at
    ``parent_root`` and by this checkout in turns parent, change, change,
    parent, each in a process of its own: host wall, ingest rate or
    ms/frame, launches and, for the serves, the summed wall of two ingest
    stages (the tracker's matcher and the unmatched scan, the card
    synchronised around each call) side by side. The answers, the
    clusters and the choice, or the boxes and the background, must be
    identical in all four runs. Last, the kernels both trees have, timed
    by one method in each tree's process, in the same turns."""
    base = ["--stream", "jacksonh", "--fps", "30", "--tenants", "4",
            "--rounds", "3", "--device", "cuda"]
    paths = {"default_120s": base + ["--duration", "120"],
             "oneshot_600s": base + ["--duration", "600", "--model",
                                     "cheap1", "--seed", "0", "--K", "1000",
                                     "--T", "0.4"]}
    trees = {"parent": os.path.join(os.path.abspath(parent_root), "src"),
             "change": SRC}
    for tree in trees.values():
        check(os.path.isdir(os.path.join(tree, "repro_torch")),
              f"no repro_torch under {tree}")
    for path, argv in paths.items():
        runs = _turns(COMPARE_CHILD, trees, [json.dumps(argv)])
        same = {(r["answers_sha256"], r["clusters"], json.dumps(r["choice"]))
                for r in runs}
        check(len(same) == 1, f"{path}: parent and change answer "
              f"differently: {same}")
        emit({"phase": f"compare_{path}", "gpu": smi, "argv": argv,
              "runs": runs, "answers_identical": True,
              "elapsed_s": elapsed()})
    runs = _turns(COMPARE_BGSUB, trees, ["120"])
    same = {(r["boxes_sha256"], r["background_sha256"]) for r in runs}
    check(len(same) == 1, f"bgsub_120s: parent and change differ: {same}")
    emit({"phase": "compare_bgsub_120s", "gpu": smi, "runs": runs,
          "boxes_identical": True, "background_identical": True,
          "elapsed_s": elapsed()})
    emit({"phase": "compare_kernels", "gpu": smi,
          "runs": _turns(COMPARE_KERNELS, trees, [HERE]),
          "elapsed_s": elapsed()})


def main():
    import numpy as np
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
    from repro_torch.common.config import CHEAP_CNNS
    from repro_torch.common.device import resolve_device
    from repro_torch.data.video import get_stream
    from repro_torch.hopper import build, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import cnn

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
    if len(sys.argv) == 3 and sys.argv[1] == "--compare":
        compare(sys.argv[2], smi)
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0

    # -- phase 2: kernels against plain versions ------------------------------
    crops, frames = get_stream("jacksonh", duration_s=10,
                               fps=30).objects_array()[:2]
    # the serve path's CNN: full-width cheap1 from seeded random weights
    mcfg = CHEAP_CNNS["cheap1"]
    forward = cnn.make_forward(cnn.build(mcfg, cnn.init_params(mcfg, seed=0),
                                         dev))
    probs = forward(torch.from_numpy(crops[:512]).to(dev))[0].contiguous()
    ca, pm, dq, tk, mg, fa, extra = kernel_phase(
        ops, ref, dev, (crops, frames), probs, peaks)
    emit({"phase": "kernels", "gpu": smi, **extra,
          "device_time_source": sorted(DEVICE_TIME_SOURCE),
          "elapsed_s": elapsed()})
    emit({"phase": "tracker", "gpu": smi, **tracker_turns(ops, dev),
          "elapsed_s": elapsed()})

    # -- phase 3: the served paths -------------------------------------------
    def drive(path, path_argv, kernels, duration):
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
        extra = default_report(report) if path == "default" else {}
        emit({"phase": f"{path}_path", "gpu": smi, "argv": path_argv,
              "duration_s": duration, "wall_s": wall, "launches": launches,
              **extra, **{k: v for k, v in report.items()
                          if k not in ("answers", "selection")}})
        return report, launches

    # the default path: spec1-spec3 trained in this run (an empty model
    # cache), swept, selected, ingested with the chosen one and served
    from repro_torch.core.ingest import IngestConfig
    from repro_torch.launch import zoo
    default_s = 120
    default_argv = ["--stream", "jacksonh", "--duration", str(default_s),
                    "--fps", "30", "--tenants", "4", "--rounds", "3",
                    "--device", "cuda"]
    cache_dir = zoo.CACHE_DIR
    with tempfile.TemporaryDirectory() as cache:
        zoo.CACHE_DIR = cache
        try:
            report, default = drive("default", default_argv,
                                    ("centroid_assign", "pixel_match"),
                                    default_s)
            # the same serve with its ingest through the sharded pipeline
            # on a one-card mesh, in 8 chunks, on the models just trained
            mesh_report, mesh_serve = drive(
                "mesh_serve", default_argv + ["--mesh-devices", "1",
                                              "--stream-chunks", "8"],
                ("centroid_assign", "pixel_match"), default_s)
        finally:
            zoo.CACHE_DIR = cache_dir
        check(all(m["train_s"] is None
                  for m in mesh_report["selection"]["models"].values()),
              "the --mesh-devices serve retrained a model")
        check(mesh_report["selection"]["choice"]
              == report["selection"]["choice"],
              "the --mesh-devices serve chose another configuration")
        check(list(mesh_report["answers"]) == list(report["answers"])
              and all(np.array_equal(mesh_report["answers"][x], a)
                      for x, a in report["answers"].items()),
              "the --mesh-devices serve answers differ from the one-shot's")
        # the chosen model, loaded from this run's cache, for phase 5
        choice = report["selection"]["choice"]
        crops_d, _, _, labels_d = get_stream(
            "jacksonh", duration_s=default_s, fps=30).objects_array()
        chosen, _, chosen_map = zoo.get_model(
            "jacksonh", choice["model"], crops_d, labels_d, default_s,
            steps=150, Ls=6, device="cuda", cache_dir=cache)
        check(chosen.train_s is None, "phase 5 retrained the chosen model")
        chosen_cfg = IngestConfig(K=choice["K"], threshold=choice["T"],
                                  max_clusters=2048)
    gate, gate_boxes, gate_bg = bgsub_path(ops)
    emit({"phase": "bgsub_path", "gpu": smi, **gate, "elapsed_s": elapsed()})
    mg["launches"] = gate["turns"][1]["launches"]           # windowed
    mg["launches_per_frame_path"] = gate["turns"][0]["launches"]

    # the override paths: seeded random weights rank the same classes first
    # for every crop, so the index ranks all 1000 classes (K=1000) and
    # clusters at T=0.4, where the random features still separate tracks:
    # every query then reaches the GT pass
    serve_args = {"K": 1000, "T": 0.4}
    duration = 600
    argv = ["--stream", "jacksonh", "--duration", str(duration),
            "--fps", "30", "--model", "cheap1", "--seed", "0",
            "--tenants", "4", "--rounds", "3", "--K", str(serve_args["K"]),
            "--T", str(serve_args["T"]), "--device", "cuda"]
    _, oneshot = drive("oneshot", argv, ("centroid_assign", "pixel_match"),
                       duration)
    with tempfile.TemporaryDirectory() as arch:
        archive_argv = argv + ["--archive", arch, "--shard-objects", "2048",
                               "--stream-chunks", "8"]
        report, archive = drive("archive", archive_argv,
                                ("centroid_assign", "pixel_match",
                                 "dequant_topk"), duration)
        check(report["shards"] > 1, "the archive path sealed one shard")
        with open(os.path.join(arch, "catalog.json")) as f:
            shards = json.load(f)["shards"]
        largest = max(shards, key=lambda m: m["n_clusters"])
        entry = dequant_entry(ops, ref, dev,
                              os.path.join(arch, largest["path"]),
                              serve_args["K"], peaks)
    entry["max_abs_err"] = max(entry["max_abs_err"], dq["max_abs_err"])
    dq.update(entry)
    pipe = pipeline_path(ops, forward, mcfg, serve_args, duration)
    emit({"phase": "pipeline_path", "gpu": smi, **pipe,
          "elapsed_s": elapsed()})
    t_multi = time.perf_counter()
    multi = multistream_path(ops, forward, mcfg)
    emit({"phase": "multistream_path", "gpu": smi, **multi,
          "serve_mesh_devices_1": {
              "argv": ["--mesh-devices", "1", "--stream-chunks", "8"],
              "launches": mesh_serve, "choice_equal": True,
              "answers_equal": True,
              "ingest_objects_per_s": mesh_report["ingest_objects_per_s"]},
          "path_s": time.perf_counter() - t_multi, "elapsed_s": elapsed()})
    for entry in (ca, pm):
        entry["launches"] = oneshot[entry["name"]]
        entry["launches_default"] = default[entry["name"]]
        entry["launches_archive"] = archive[entry["name"]]
        entry["launches_pipeline"] = pipe["launches"][entry["name"]]
        entry["launches_multistream"] = multi["launches"][entry["name"]]
        entry["launches_mesh_serve"] = mesh_serve[entry["name"]]
    dq["launches"] = archive["dequant_topk"]
    tk["launches"] = pipe["launches"]["topk"]
    tk["launches_multistream"] = multi["launches"]["topk"]
    lm = lm_path(ops, peaks)
    emit({"phase": "lm_path", "gpu": smi, **lm, "elapsed_s": elapsed()})
    fa["launches"] = lm["launches"]["flash_attention"]

    # -- phase 4: card against CPU --------------------------------------------
    emit({"phase": "card_vs_cpu", **card_vs_cpu(serve_args),
          "bgsub": bgsub_card_vs_cpu(gate_boxes, gate_bg),
          "selection": selection_card_vs_cpu(),
          "training": train_card_vs_cpu(), "lm": lm_card_vs_cpu(),
          "elapsed_s": elapsed()})
    override = cnn.make_apply(cnn.build(mcfg, cnn.init_params(mcfg, 0), dev))
    override_cfg = IngestConfig(K=serve_args["K"], threshold=serve_args["T"])
    emit({"phase": "breakdown", "gpu": smi,
          "override": breakdown(override, override_cfg,
                                {"n_local_classes": 1000}),
          "default": breakdown(chosen, chosen_cfg, {"class_map": chosen_map}),
          "elapsed_s": elapsed()})
    check(elapsed() < LIMIT_S, f"over the {LIMIT_S} s limit")

    emit({"phase": "launches_per_path", "gpu": smi, **{
        name: {"oneshot_600s": oneshot[name], "archive_600s": archive[name],
               "pipeline_600s": pipe["launches"][name],
               "default_serve_120s": default[name],
               "mesh_serve_120s": mesh_serve[name],
               "multistream_8x120s": multi["launches"][name]}
        for name in ("pixel_match", "centroid_assign")}})
    emit({"kernels": [ca, pm, dq, tk, mg, fa]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
