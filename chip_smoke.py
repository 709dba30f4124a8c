#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: the quickest proof that the port builds, is right, and serves on
the card.

  python3 chip_smoke.py                 # from the root of a checkout
  python3 chip_smoke.py --compare DIR   # the default serve, the 600 s
                                        # one-shot, the multi-stream
                                        # runner, background subtraction
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
   against +0.0 tie among its checks) and at the MoE router's shapes
   (8192 x 64 with k = 6, 4 x 64, 8192 x 16 with k = 4, tied experts
   among them) against ``torch.topk``, ``dequant_topk`` also on rows whose
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
   stacked step, ≤ 2 dispatches a step; a rollover on a 30 s cut (2048
   objects per shard) equal to solo rollovers; ``make_ingest_mesh`` past
   the card count raising its actionable error; and the 30 s cut on two
   blocks of this one card (``IngestMesh((cuda:0, cuda:0))``, block 1 on
   its own replica of the forward), in turns with one block, each
   stream's index, counters and sink equal to its solo pipeline's,
   ``centroid_assign`` and ``topk`` once per (step, active block) pair,
   and the staged ``MultiStreamRunner`` on that cut equal too.
   Each path's launch counters
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
   largest |logit|. Then the MoE LMs (``moe_path``, through the same
   ``lm_path``): moonshot-v1-16b-a3b at full width with 16 of its 48
   layers (64 experts top-6; init time and peak memory) and dbrx-132b
   at full width with 2 layers, each prefilled on both routes
   in both dispatch modes (``einsum``, ``scatter``) against one bound
   per model, the function's work on the choices it keeps (capacity
   padding and GShard's dispatch products reported beside it as the
   code's extra work), and decoded as above against the bytes of the
   experts each step routes to, ``flash_attention`` once per layer per
   flash call and the
   router's ``topk`` once per layer per forward call and per decode
   step; in fp32 at 2 layers the routes within 1e-4 and the dispatch
   modes within 1e-5, each pair's routing compared (identical choices
   wherever the smallest top-k margin exceeds the router difference).
   Then LM training (``train_path``): olmo-1b at full
   width and depth through ``repro_torch.launch.train``'s ``main``
   (``--full --steps 20 --batch 8 --seq 2048 --microbatches 2``, bf16,
   remat on): init s, the device ms/step (median of steps 3-20, the card
   synchronised around each step), tokens/s, achieved TFLOP/s against
   the step's bound from the code (``train_step_work``), peak memory,
   one more step under the profiler (device time by kernel category,
   idle share), the first and last loss finite and the last no higher;
   all six launch counters read 0 after it (JAX's training path computes
   attention on the einsum route). Then ``train_resume`` at olmo-1b's
   width with 2 layers (bf16, 2 micro-batches, int8 error feedback):
   the same 3 steps twice bitwise, 6 steps uninterrupted against 3 with
   a checkpoint and a resumed run to 6, bitwise, a bf16 leaf restored
   bitwise, a fake preemption at step 2 checkpointing and returning,
   checkpoint write and restore times. Then the step builders
   (``steps_path``, one line per cell): cells of
   ``repro_torch.launch.steps`` built at full width in bf16 (each global
   batch, cache or depth cut printed) and run on ``init(cfg, seed=0)``
   weights and seeded data: olmo-1b's train_4k at batch 2 under the remat
   policies ``nothing``, ``dots_nobatch`` and ``dots`` (ms/step, the
   median of steps 2-4, peak GB, idle share of one profiled step; losses
   and parameters bitwise equal across the policies), prefill_32k at
   batch 2 (the serve step picks the flash route itself: 16
   ``flash_attention`` launches a call), decode_32k at batch 4 on a
   filled 32768-slot cache, long_500k (its ``skip_reason``, then the
   window variant's decode on 65536 slots); granite-34b with 4 of 88
   layers: prefill_32k at batch 2 through the long-prefill recipe (2
   halves, 8 launches a call) and decode_32k at batch 8; moonshot with
   2 of 48 layers: train_4k at batch 4 in its 4 micro-batches (``topk``
   16 times a step under remat); each against its bound
   (``train_step_work`` without remat's recompute, for MoE on the kept
   choices; ``prefill_work``; the decode's bytes, a window's slots only).
   After the path's launch counters are read (``long_prefill_checks``):
   ``flash_attention`` at the two S = 32768 shapes the built prefill
   steps launch it at (2 x 32768 x 16 x 128 and 1 x 32768 x 48 x 128,
   bf16) against the plain version block by block over the queries, to
   one bf16 ulp, timed beside that blocked plain version and SDPA, with
   ``flash_entry``'s bound; and each prefill_32k step built at 2 layers
   in fp32, its flash route against the einsum route with 1024-row query
   blocks, within 1e-4 of the largest |logit|.
   Last, the vision and diffusion models at full width in bf16
   (``vision_path``, one line per model), served through their built
   serve steps: vit-l16 (init, the serve step at serve_b128 and at
   cls_384's shape as a serve cell with its pos table resized 14 -> 24,
   ``features_only``, a built cls_224 train step at batch 8, then
   ``launch.train --arch vit-l16 --full`` at batch 32 with remat), deit-b
   (serve step at batch 128), dit-b2 (the gen_fast serve step, the DDIM
   sampler: 16 latents of 64 x 64 x 4, 1024 tokens, 4 steps; a built
   train_256 step at batch 8; then ``launch.train --arch dit-b2 --full``
   at 256 px) and efficientnet-b7 (serve step at 600 px, batch 8; a
   built cls_224 train step at batch 8; then ``launch.train --arch
   efficientnet-b7 --full``): images/s or ms per sampler step, ms per
   training step, peak GB, the bound from the function's operations and
   bytes (every product on the bf16 tensor cores, 3 passes a training
   step) with the code's extra work beside it as ms at peak (the fp32
   q.k^T, remat's recompute); none of the six kernels launches.
   Then the multi-card layer (``mesh_path``): a one-rank NCCL group and
   ``launch.mesh.make_mesh((1, 1), ("data", "model"))`` (its backend and
   NCCL's version printed); olmo-1b at full width with 2 layers through
   the built train_4k step on the mesh (batch 2 x 4096, 2 steps) beside
   the unsharded step from the same weights, loss lines, AdamW moments
   and parameter changes bitwise equal (else held to 1e-6 of each leaf's
   largest |change|); its built prefill_32k step (batch 2) with
   ``flash_attention`` through ``local_map``, 2 launches a call, logits
   bitwise the unsharded step's; moonshot at full width with 2 layers
   prefilling 1 x 2048 tokens with its experts on ``"model"``, ``topk``
   and ``flash_attention`` 2 launches each a call, routing and logits
   equal to unsharded; moonshot's built train_4k step (batch 4 x 4096 in
   4 micro-batches, one step; its experts' weights gathered over
   ``"data"`` before their products, ROADMAP C26) on the mesh beside the
   unsharded step, loss, AdamW moments and parameters bitwise equal,
   ``topk`` through ``local_map`` 16 launches; ``compressed_psum`` over
   ``"data"`` on a (2048, 8192) fp32 tensor bitwise the int8 round trip,
   timed; the trained state saved from the mesh, restored onto it and
   resharded onto ``choose_mesh()``, every leaf bitwise on its
   placement; 0 ``constrain`` misses. One card shows a one-rank mesh only: the
   multi-rank semantics are ``tests/test_torch_mesh.py``'s (4 gloo
   ranks on the CPU).
   Then ``gate_tune_path``: ``launch.hillclimb.gate_tune`` (the
   redundancy gate and the adaptive sampler, window by window, with the
   recall probe) on the card at the JAX package's defaults, its record
   equal to the CPU run's, ``pixel_match`` and ``centroid_assign``
   launched; again over 3600 frames, the gate's ms per frame (its match
   calls, host-inclusive) and its ring's upload bytes per call, and
   both kernels held against their plain versions on the inputs that
   run gave them (the largest ring, the last centroid table) and on
   crops planted within 1% of the threshold. Then ``dryrun_path`` runs
   ``launch.dryrun`` in subprocesses on this torch:
   olmo-1b train_4k and prefill_32k, moonshot prefill_32k (its
   all-to-all planned as NCCL would) and train_4k, dbrx-132b train_4k
   and vit-l16 cls_224, each on the (16, 16) and (2, 16, 16) fake meshes;
   each record's summary line is printed, and any record not ``ok``
   fails the smoke; for the two MoE train cells the wire bytes at the
   lines of ``layers.moe`` (the experts' weights gathered, their output
   moved), and none among the largest at the expert products (ROADMAP
   C26) (the modelled cluster's numbers, traced on the host: no kernel
   runs);
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
   largest |logit|, and so does moonshot-v1-16b-a3b at its full width
   with 2 layers (its routes compared as above), and the threefry draws
   of the cheap CNNs and of reduced olmo-1b and moonshot are bitwise
   equal on the card and on the CPU; the same 2-layer LM in fp32, and
   reduced moonshot (the backward through the router and the dispatch),
   trained 3 steps of 1 x 64 tokens from one init on each device: the
   first step's gradients within 1e-5 of each leaf's largest |grad|, the
   losses within 1e-5 relative, the parameters within 2 lr per step
   (``train_card_vs_cpu_lm`` says why); reduced vit-s16, deit-b,
   efficientnet-b7 and dit-b2 in fp32 (``vision_card_vs_cpu``): the draws
   bitwise, forward outputs, batch-norm state, first-step gradients and
   DiT's ``sample`` within 1e-5;
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
round one fp32 result to bf16 once); LM training on one device repeated
and resumed bitwise, card against CPU as in phase 4; MoE routing (expert
choice, slots, capacity cut) identical between two runs wherever the
router's smallest top-k margin exceeds the two runs' difference in
router probabilities.
"""
# focuslint: disable-file=host-sync -- a measurement script: it synchronises
# the card around every timed region and reads every result back to check it
from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

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
# The MoE path, the same prefills and decode: moonshot-v1-16b-a3b at full
# width with 16 of its 48 layers (28.06 B parameters and 56.1 GB in bf16
# at full depth, which fits the card too; cut to a third to keep the
# smoke inside its limit on a slow card), and dbrx-132b at full width
# with 2 of its 40 layers (131.6 B parameters in full, 263 GB); the fp32
# checks at full width with 2 layers (the full moonshot would take 112
# GB in fp32)
MOE_MOONSHOT_LAYERS, MOE_DBRX_LAYERS = 16, 2
MOE_ARCHS = (("moonshot-v1-16b-a3b", MOE_MOONSHOT_LAYERS),
             ("dbrx-132b", MOE_DBRX_LAYERS))
MOE_CHECK_LAYERS = 2
# phase 4's card-against-CPU LM: olmo-1b's width with 2 layers
LM_CPU_LAYERS, LM_CPU_BATCH, LM_CPU_SEQ = 2, 2, 256
# LM training: olmo-1b at full width and depth through the training
# entry point (bf16, remat on, 2 micro-batches of 4 x 2048 tokens, 20 steps);
# resume and preemption at full width with 2 layers; card against CPU
# at full width with 2 layers in fp32, 3 steps of 1 x 64 tokens
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_MB = 8, 2048, 20, 2
RESUME_LAYERS, RESUME_BATCH, RESUME_SEQ = 2, 4, 512
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, TRAIN_CPU_STEPS = 1, 64, 3
# The vision path, each model at full width in its config's bf16: vit-l16
# at serve_b128 and cls_384 (the JAX package's shape cells) and trained
# at batch 32 with remat, deit-b at batch 128, dit-b2's sampler at
# gen_fast and training at 256 px, efficientnet-b7 at 600 px; each
# forward timed over VISION_ITERS calls, each training VISION_TRAIN_STEPS
# steps (EfficientNet's EFF_TRAIN_STEPS)
VIT_TRAIN_BATCH, DEIT_BATCH, DIT_TRAIN_BATCH = 32, 128, 32
EFF_BATCH, EFF_TRAIN_BATCH, EFF_TRAIN_STEPS = 8, 8, 4
VISION_TRAIN_STEPS, VISION_ITERS = 6, 10
# The step builders (``steps_path``): cells of ``repro_torch.launch.steps``
# at full width in bf16, each global batch cut to one card: olmo-1b's
# train_4k at batch 2 under each remat policy, prefill_32k at batch 2,
# decode_32k at batch 4 and long_500k's window variant with its cache cut
# to 65536 slots; granite-34b with 4 of its 88 layers (prefill_32k at
# batch 2, decode_32k at batch 8); moonshot-v1-16b-a3b with 2 of its 48
# layers (train_4k at batch 4 in its 4 micro-batches); and in
# ``vision_path`` a built train step per vision family at a small batch
STEPS_TRAIN_BATCH, STEPS_TRAIN_STEPS = 2, 4
STEPS_PREFILL_BATCH, STEPS_PREFILL_CALLS = 2, 2
STEPS_DECODE_BATCH = {"olmo-1b": 4, "granite-34b": 8}
STEPS_DECODE_STEPS, STEPS_WINDOW_SLOTS = 8, 65536
STEPS_GRANITE_LAYERS, STEPS_MOE_LAYERS = 4, 2
# the prefill_32k cells checked in fp32 at this depth (``long_prefill_checks``)
STEPS_CHECK_LAYERS = 2
STEPS_MOE_BATCH, STEPS_MOE_STEPS = 4, 3
STEPS_VISION_BATCH, STEPS_VISION_STEPS = 8, 3
# The multi-card layer on a one-rank NCCL mesh (``mesh_path``): olmo-1b
# and moonshot-v1-16b-a3b at full width cut to 2 layers; olmo-1b's built
# train_4k at batch 2 for 2 steps and prefill_32k at batch 2 (the steps
# path's cuts), moonshot prefilling 1 x 2048 tokens and its train_4k at
# batch STEPS_MOE_BATCH for one step; compressed_psum on a (2048, 8192)
# fp32 tensor
MESH_LAYERS, MESH_TRAIN_STEPS = 2, 2
MESH_MOE_BATCH, MESH_MOE_SEQ = 1, 2048
MESH_PSUM_SHAPE = (2048, 8192)
# where the mesh path runs: the card, over NCCL
MESH_DEVICE = "cuda"


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


def router_probs(dev, B, E, seed, levels=None):
    """(B, E) fp32 rows as the MoE router makes them: the softmax of
    N(0, 1) logits (moonshot's router logits at init have about unit
    spread); with ``levels``, the logits rounded to that many levels per
    unit, so that experts tie."""
    import numpy as np
    import torch
    logits = np.random.default_rng(seed).normal(size=(B, E))
    if levels is not None:
        logits = np.round(logits * levels) / levels
    x = torch.from_numpy(logits.astype(np.float32)).to(dev)
    return torch.softmax(x, dim=-1).contiguous()


def router_topk_entry(ops, ref, dev, peaks):
    """``topk`` at the MoE router's shapes against its plain version:
    moonshot's prefill (8192 tokens, 64 experts, k = 6) and decode step
    (4 tokens), dbrx's prefill and decode step (16 experts, k = 4), each
    also with tied logits and a row of equal probabilities (experts
    0..k-1); then timed at moonshot's prefill shape against the plain
    version and ``torch.topk`` (which keeps no tie rule: a yardstick
    only)."""
    import torch
    errs = []
    for B, E, k in ((8192, 64, 6), (4, 64, 6), (8192, 16, 4), (4, 16, 4)):
        for levels in (None, 2):
            x = router_probs(dev, B, E, B + E, levels)
            x[B // 2] = 1.0 / E
            err, i = _topk_pair(ops, ref, x, k)
            check(i[B // 2].tolist() == list(range(k)),
                  f"router topk tie: {i[B // 2].tolist()}")
            errs.append(err)
    B, E, k = LM_BATCH * LM_SEQ, 64, 6
    probs = router_probs(dev, B, E, 0)
    n_bytes = 4 * B * E + 8 * B * k
    return {
        "path_shape": "moonshot's router at a 4 x 2048 prefill",
        "shape": [B, E, k], "cases": len(errs), "max_abs_err": max(errs),
        **timings(lambda: ops.topk(probs, k), lambda: ref.topk_ref(probs, k),
                  lambda: torch.topk(probs, k, dim=1)),
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
          "max_abs_err": tk_err, **topk_entry(ops, ref, probs, peaks),
          "router": router_topk_entry(ops, ref, dev, peaks)}
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


def lm_config(arch=LM_ARCH, **overrides):
    """An LM of the registry (by default the LM path's, ``LM_ARCH``), with
    ``overrides``."""
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch), **overrides)


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


def flash_bound(q, peaks):
    """The least time of causal ``flash_attention`` on q, k, v shaped as
    ``q`` (B, S, H, dh), by operations: the causal half of the two
    products, S(S+1)/2 score pairs per head at 2*dh operations each per
    product. q.k^T has bf16 operands; p.v has fp32 p (the JAX kernel
    keeps it fp32), which is p_hi + p_lo, two bf16 terms, against bf16 v:
    so all of it runs on the bf16 tensor cores, q.k^T once and p.v twice
    (``tensor_gflop``). Bytes: q, k, v read once, the output written
    once. Beside it, the bound with p.v at fp32's peak
    (``bound_p_fp32_ms``, the bound before the split)."""
    B, S, H, dh = q.shape
    n_ops = 2 * B * H * dh * S * (S + 1)
    tensor_ops = n_ops / 2 + 2 * n_ops / 2
    n_bytes = 4 * q.numel() * q.element_size()
    op_s = tensor_ops / peaks["bf16_tc"]
    by_s = n_bytes / peaks["bytes"]
    return {"shape": [B, S, H, dh], "dtype": str(q.dtype), "causal": True,
            "gflop": n_ops / 1e9, "tensor_gflop": tensor_ops / 1e9,
            "mbytes": n_bytes / 1e6,
            "bound_ms": 1e3 * max(op_s, by_s),
            "bound_by": "operations" if op_s > by_s else "bytes",
            "bound_p_fp32_ms": 1e3 * max(n_ops / 2 / peaks["bf16_tc"]
                                         + n_ops / 2 / peaks["fp32"], by_s)}


def flash_entry(ops, ref, q, k, v, peaks):
    """``flash_attention`` timed at the LM path's shape (causal bf16), with
    its bound (``flash_bound``); ``tensor_tflops`` is the tensor work over
    the kernel's time. SDPA on the (B, H, S, dh) view is the library
    yardstick, never called by the port."""
    import torch
    import torch.nn.functional as F
    check(q.dtype == torch.bfloat16, "flash_entry times the bf16 path")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bound = flash_bound(q, peaks)
    t = timings(lambda: ops.flash_attention(q, k, v, causal=True),
                lambda: ref.flash_attention_ref(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
    return {**bound, **t,
            "tensor_tflops": bound["tensor_gflop"] / t["ms"]}


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
# phase 3: multi-stream ingest (the sharded runner on one card)
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
    Then a rollover run on a 30 s cut of them (2048 objects per shard)
    against solo rollovers, and ``make_ingest_mesh(2)``'s error on a
    one-card machine. Records whether
    a stacked forward (8 x 512 crops) gives the solo forward's rows. Last,
    ``multistream_two_blocks``: two blocks on this one card."""
    import numpy as np
    import torch
    from repro_torch.core.ingest import IngestConfig
    from repro_torch.core.streaming import make_sharded_runner
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

    del solo, rounds

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
        "bytes_identical": True, "per_stream": per_stream,
        "stacked_forward_rows_equal_solo": rows_equal,
        "mesh_error": "make_ingest_mesh(n > cards) raised ValueError",
        "rollover": multistream_rollover(forward, cfg, flops),
        "two_blocks": multistream_two_blocks(ops, forward, cfg, flops),
    }


def multistream_two_blocks(ops, forward, cfg, flops, duration=30,
                           n_chunks=4):
    """The eight streams' ``duration`` s cut through ``make_sharded_runner``
    on ``IngestMesh((card, card))``, ``forward``'s card (``cuda:0``): two
    blocks on one card, block 0 on ``forward`` and block 1 on its own
    replica (one card shows a second block only so: ``make_ingest_mesh``
    refuses more blocks than cards). Runs in turns one block, two, two,
    one on the same chunks (launch counters zeroed just before the first
    two-block turn and read just after it), then each stream's solo
    pipeline and the staged ``MultiStreamRunner`` (each stream's batch
    forwarded at its solo shape): every turn's and the staged runner's
    bytes equal the solo run's, the turns' counters and sinks too, and
    ``centroid_assign`` and ``topk`` launch once per (step, active
    block) pair. The walls show what block 1's replica and its second
    dispatch a step cost."""
    import torch
    from repro_torch.core.pipeline import staged_cheap_apply
    from repro_torch.core.streaming import (MultiStreamRunner,
                                            StreamingIngestor,
                                            make_sharded_runner)
    from repro_torch.data.video import get_stream
    from repro_torch.launch.mesh import IngestMesh
    from repro_torch.models.cnn import CheapForward

    streams = {nm: get_stream(nm, duration_s=duration,
                              fps=30).objects_array()[:2]
               for nm in MULTI_STREAMS}
    n_objects = sum(len(c) for c, _ in streams.values())
    rounds = _chunked(streams, n_chunks)
    del streams
    card = next(forward.parameters()).device
    turns, launches, replica = [], None, None
    for n_blocks in (1, 2, 2, 1):
        digests = {}
        runner = make_sharded_runner(
            forward, IngestMesh((card,) * n_blocks), list(MULTI_STREAMS),
            cfg=cfg, topk_sink=_digest_sink(digests), n_local_classes=1000,
            cheap_flops_per_image=flops)
        torch.cuda.synchronize()
        counted = n_blocks == 2 and launches is None
        if counted:
            ops.reset_launches()
        t0 = time.perf_counter()
        for chunks in rounds:
            runner.feed(chunks)
            runner.flush()
        got = runner.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = runner.pipeline.stats
        if counted:
            launches = dict(ops.LAUNCHES)
            check(st.n_block_steps > st.n_steps,
                  "no step of the two-block run had both blocks active")
            for k in ("centroid_assign", "topk"):
                check(launches[k] == st.n_block_steps,
                      f"{k} launched {launches[k]} times in "
                      f"{st.n_block_steps} (step, active block) pairs")
            check(launches["pixel_match"] > 0, "pixel_match never launched")
            fw = runner.pipeline.forwards
            pairs = list(zip(fw[1].parameters(), forward.parameters(),
                             strict=True))
            check(fw[0] is forward and fw[1] is not forward
                  and isinstance(fw[1], CheapForward)
                  and all(p.device == card and p.data_ptr() != q.data_ptr()
                          and torch.equal(p, q) for p, q in pairs),
                  "block 1 does not run a replica of block 0's forward")
            replica = {"distinct_module": True, "own_storage": True,
                       "same_weights": True, "device": str(card)}
        turns.append({"blocks": n_blocks, "wall_s": wall,
                      "objects_per_s": n_objects / wall,
                      "steps": st.n_steps, "block_steps": st.n_block_steps,
                      "dispatches": st.n_dispatches,
                      "got": {nm: (index.save_bytes(),
                                   vars(stats) | {"wall_s": 0},
                                   digests[nm].digest())
                              for nm, (index, stats) in got.items()}})
        del runner, got
    solo_digests = {}
    solo, solo_wall = _solo_pipelines(forward, cfg, flops, rounds,
                                      solo_digests)
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
    del staged, staged_got
    for t in turns:
        for nm in MULTI_STREAMS:
            got_bytes, got_stats, got_digest = t["got"][nm]
            check(got_bytes == solo[nm][0],
                  f"{nm}: the {t['blocks']}-block index differs from the "
                  f"solo pipeline's")
            check(got_stats == solo[nm][1],
                  f"{nm}: {t['blocks']}-block counters differ from solo")
            check(got_digest == solo_digests[nm].digest(),
                  f"{nm}: the {t['blocks']}-block sink differs from solo")
        del t["got"]
    return {"mesh": [str(card)] * 2, "duration_s": duration,
            "chunks_per_stream": n_chunks, "objects": n_objects,
            "launches": launches, "replica": replica, "turns": turns,
            "solo_pipelines_wall_s": solo_wall,
            "staged_runner_wall_s": staged_wall,
            "staged_runner_objects_per_s": n_objects / staged_wall,
            "bytes_identical": True}


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


@contextlib.contextmanager
def recorded_routes():
    """Every ``layers.moe_route`` call inside the block, in call order, as
    host tensors [probs, idx, within, keep]: observation only, the
    routes themselves untouched."""
    from repro_torch.models import layers
    calls, route = [], layers.moe_route

    def record(*a):
        out = route(*a)
        # a DTensor route (the mesh path) is gathered whole first
        whole = [t.full_tensor() if hasattr(t, "full_tensor") else t
                 for t in out]
        calls.append([whole[0].detach().float().cpu()]
                     + [t.cpu() for t in whole[3:]] + [whole[1].cpu()])
        return out

    layers.moe_route = record
    try:
        yield calls
    finally:
        layers.moe_route = route


def route_agreement(a, b, k, what):
    """Two runs' routes (``recorded_routes``) on the same inputs, MoE call
    by call. Per token: its top-k margin in b (the smallest gap among its
    k + 1 largest router probabilities: it decides the choices and their
    order, hence the slots) and the largest difference between the two
    runs' probabilities for it. Up to the first call where a token's
    choices differ, every token whose margin exceeds its difference must
    choose identically, and a flip is allowed only at a near-tie; a group
    whose tokens all chose identically must give identical slots and
    capacity cuts. Past a flip a call's inputs may differ by it, so later
    calls are reported, not held."""
    import torch
    check(len(a) == len(b) > 0, f"{what}: {len(a)} against {len(b)} MoE "
          f"calls")
    margins, diffs, near, flip_at, flipped = [], [], 0, None, []
    for n, (x, y) in enumerate(zip(a, b)):
        srt = torch.sort(y[0], dim=-1, descending=True).values[..., :k + 1]
        margin = (srt[..., :-1] - srt[..., 1:]).amin(-1)       # (G, gs)
        diff = (x[0] - y[0]).abs().amax(-1)
        margins.append(float(margin.min()))
        diffs.append(float(diff.max()))
        if flip_at is not None:
            continue
        held = margin > diff
        near += int((~held).sum())
        differ = (x[3] != y[3]).any(-1)
        check(not bool((differ & held).any()),
              f"{what}: MoE call {n} routes {int((differ & held).sum())} "
              f"tokens otherwise whose margin exceeds the difference")
        same_group = ~differ.any(-1)
        for u, v in zip(x[1:3], y[1:3]):            # within, keep
            check(torch.equal(u[same_group], v[same_group]),
                  f"{what}: MoE call {n}: equal choices, other slots")
        if bool(differ.any()):
            flip_at = n
            flipped = [{"margin": float(margin[i]), "diff": float(diff[i])}
                       for i in zip(*torch.nonzero(differ, as_tuple=True))]
    return {"calls": len(a), "first_flip_call": flip_at,
            "tokens_flipped": flipped, "near_ties_before_flip": near,
            "min_margin": min(margins), "max_prob_diff": max(diffs)}


def prefill_work(cfg, batch, seq, kept=None, attn_impl=None,
                 dispatch=None):
    """The work of one prefill of ``batch`` x ``seq`` tokens by category,
    each (bf16 tensor-core FLOP, fp32 FLOP). With no ``attn_impl``, the
    function's, whatever computes it: per layer the attention
    projections, 2 FLOP per weight and token; causal attention, the
    causal half of q.k^T and of p.v (S(S+1)/2 pairs per sequence and
    head, 2 dh FLOP each per product) on the bf16 tensor cores; the dense
    MLP, or for MoE the fp32 router (2 D E a token) and the experts'
    three products for the ``kept`` (token, choice) pairs that this run
    routed, summed over the layers (a dropped choice costs nothing);
    then the fp32 head on the last position. With ``attn_impl`` and
    ``dispatch``, the code's: attention on the einsum route the fp32
    q.k^T (TF32 off) and the bf16 p.v over the full S^2 (one query
    block: ``attn_q_chunk`` >= S), on the flash route the causal half
    with p.v twice (``flash_entry``); the experts over all E x G x C
    capacity slots, filled or not; with the einsum dispatch, GShard's
    dispatch and combine products, 2 G gs E C D each."""
    from repro_torch.models.layers import moe_groups
    tokens, D, L = batch * seq, cfg.d_model, cfg.n_layers
    n = 2 * batch * cfg.n_heads * cfg.head_dim * seq * (seq + 1)
    work = {"projections": (2 * cfg._per_layer_attn() * tokens * L, 0),
            "attention": (n * L, 0),
            "head": (0, 2 * batch * D * cfg.vocab_size)}
    if attn_impl == "flash":
        work["attention"] = (1.5 * n * L, 0)
    elif attn_impl is not None:
        s2 = 2 * batch * cfg.n_heads * cfg.head_dim * seq * seq
        work["attention"] = (s2 * L, s2 * L)
    if not cfg.moe:
        n_mat = 3 if cfg.mlp_act == "swiglu" else 2
        work["mlp"] = (2 * n_mat * D * cfg.d_ff * tokens * L, 0)
        return work
    gs, G, C = moe_groups(tokens, cfg.moe_group_size, cfg.moe_top_k,
                          cfg.moe_capacity_factor, cfg.n_experts)
    work["router"] = (0, 2 * tokens * D * cfg.n_experts * L)
    slots = kept if attn_impl is None else cfg.n_experts * G * C * L
    work["experts"] = (6 * D * cfg.d_ff * slots, 0)
    if dispatch == "einsum":
        work["dispatch"] = (4 * G * gs * cfg.n_experts * C * D * L, 0)
    return work


def work_s(work, peaks):
    """Seconds of ``prefill_work`` categories at the card's peak rates."""
    return sum(b / peaks["bf16_tc"] + f / peaks["fp32"]
               for b, f in work.values())


def needed_weight_bytes(params, cfg, rows, experts_used=None):
    """The weight bytes a call must read: every weight once, except the
    token embedding's rows that no token of the call looks up (all of it
    is read where it is also the head) and, with ``experts_used`` (the
    experts that keep a choice, summed over the layers), the experts a
    call routes nothing to."""
    size = sum(x.numel() * x.element_size() for x in _flat_tree(params))
    emb = params["tok_embed"]
    if not cfg.tie_embeddings:
        size -= (emb.shape[0] - rows) * emb.shape[1] * emb.element_size()
    if experts_used is not None:
        moe = params["layers"]["moe"]
        per_expert = sum(moe[w][0, 0].numel() * moe[w].element_size()
                         for w in ("wi", "wg", "wo"))
        size -= (cfg.n_layers * cfg.n_experts - experts_used) * per_expert
    return size


def kept_and_used(routes):
    """(kept (token, choice) pairs, experts that keep at least one),
    summed over the MoE calls of ``recorded_routes``; (None, None) for a
    dense LM."""
    if not routes:
        return None, None
    return (sum(int(r[2].sum()) for r in routes),
            sum(int(r[3][r[2]].unique().numel()) for r in routes))


def lm_path(ops, peaks, cfg, check_layers=None):
    """The decoder LM ``cfg`` served on the card: ``transformer.init`` from
    seed 0 (its time and peak memory), the prefill of ``LM_BATCH``
    prompts of ``LM_SEQ`` tokens through the flash route and the einsum
    route, for MoE in both dispatch modes (a warm-up, then the median
    wall of 3 calls each; one bound per model, the function's
    ``prefill_work`` on the kept choices that the warm-up routed, and
    beside it the code's extra work, such as capacity padding and
    GShard's dispatch products, as ms at peak), and decode: a
    ``DECODE_PROMPT``-token prompt through ``decode_step`` one token at a
    time, then ``DECODE_NEW`` greedy tokens, into a ``DECODE_SLOTS``-slot
    cache (its bytes bound both as every weight read and as what the
    function needs: the experts that keep a choice, counted by replaying
    the same tokens). The launch counters are zeroed just before and
    read just after:
    ``flash_attention`` once per layer per flash call, the MoE router's
    ``topk`` once per layer per forward call and per decode step, and no
    other kernel. Then the fp32 checks on the same weights widened to
    fp32, the first ``check_layers`` layers (all by default): the two
    prefill routes' last-position logits within 1e-4 of the largest
    |logit|; for MoE, the two dispatch modes within 1e-5, each pair of
    runs' routes compared (``route_agreement``); for a dense LM,
    ``decode_step`` fed the prompt against ``forward`` of the prompt at
    every position within 1e-4. An MoE decode step routes its B tokens as
    one group, with another capacity than ``forward``'s groups, so it has
    no such check: phase 4 holds it against the CPU."""
    import dataclasses
    import statistics
    import numpy as np
    import torch
    from repro_torch.common.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import moe_groups, moe_route

    dev = resolve_device("cuda")
    modes = ("einsum", "scatter") if cfg.moe else (cfg.moe_dispatch,)
    if cfg.moe:
        gs, G, C = moe_groups(LM_BATCH * LM_SEQ, cfg.moe_group_size,
                              cfg.moe_top_k, cfg.moe_capacity_factor,
                              cfg.n_experts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(x.numel() for x in _flat_tree(params))
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in _flat_tree(params))
    r = np.random.default_rng(0)
    tokens = torch.from_numpy(r.integers(0, cfg.vocab_size,
                                         (LM_BATCH, LM_SEQ))).to(dev)
    moe_calls = cfg.n_layers if cfg.moe else 0

    PREFILL_CALLS = 4

    prompt_rows = int(torch.unique(tokens).numel())

    def run_prefill(impl, p, c):
        walls, out = [], None
        for i in range(PREFILL_CALLS):      # a warm-up, then 3 timed calls
            before = dict(ops.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i:
                out = T.prefill(p, tokens, c, attn_impl=impl)
            else:                           # the warm-up counts the routes
                with recorded_routes() as routed:
                    out = T.prefill(p, tokens, c, attn_impl=impl)
            torch.cuda.synchronize()
            if i:
                walls.append(time.perf_counter() - t0)
            n = {k: ops.LAUNCHES[k] - before[k] for k in before}
            want = {"flash_attention": c.n_layers if impl == "flash" else 0,
                    "topk": moe_calls}
            check(all(n[k] == want.get(k, 0) for k in n),
                  f"{impl} prefill launched {n}, expected {want}")
        check(out.shape == (LM_BATCH, 1, c.vocab_size)
              and bool(torch.isfinite(out).all()),
              f"{impl} prefill logits {tuple(out.shape)} not finite")
        med = statistics.median(walls)
        kept, used = kept_and_used(routed)
        fn = prefill_work(c, LM_BATCH, LM_SEQ, kept)
        code = prefill_work(c, LM_BATCH, LM_SEQ, kept, impl, c.moe_dispatch)
        op_s = work_s(fn, peaks)
        by_s = needed_weight_bytes(p, c, prompt_rows, used) / peaks["bytes"]
        bf16 = sum(b for b, _ in code.values())
        fp32 = sum(f for _, f in code.values())
        return out, {"walls_s": walls, "median_s": med,
                     "tokens_per_s": LM_BATCH * LM_SEQ / med,
                     "launches_per_call": n, "kept_choices": kept,
                     "experts_used": used,
                     "kept_share_by_layer": [float(r[2].float().mean())
                                             for r in routed],
                     "bound_tflop": sum(b + f for b, f in fn.values()) / 1e12,
                     "code_bf16_tflop": bf16 / 1e12,
                     "code_fp32_tflop": fp32 / 1e12,
                     "achieved_tflops": (bf16 + fp32) / med / 1e12,
                     "bound_ms": 1e3 * max(op_s, by_s),
                     "bound_by": "operations" if op_s > by_s else "bytes",
                     "code_extra_ms_at_peak": {
                         k: 1e3 * (work_s({k: v}, peaks)
                                   - work_s({k: fn.get(k, (0, 0))}, peaks))
                         for k, v in code.items() if v != fn.get(k)}}

    ops.reset_launches()
    prefill, logits_of = {}, {}
    for mode in modes:
        c = dataclasses.replace(cfg, moe_dispatch=mode)
        for impl in ("flash", "einsum"):
            name = f"{impl}_{mode}" if cfg.moe else impl
            logits_of[name], prefill["prefill_" + name] = run_prefill(
                impl, params, c)
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
    fed = [tokens[:, t:t + 1] for t in range(DECODE_PROMPT)]
    for t in range(DECODE_PROMPT, DECODE_PROMPT + DECODE_NEW):
        fed.append(tok)
        logits, cache = T.decode_step(params, cache, tok, t, cfg)
        tok = logits.argmax(-1)
        generated.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    steps = DECODE_PROMPT + DECODE_NEW
    want = {"flash_attention": PREFILL_CALLS * cfg.n_layers * len(modes),
            "topk": moe_calls * (2 * PREFILL_CALLS * len(modes) + steps)}
    check(all(launches[k] == want.get(k, 0) for k in launches),
          f"the LM path's launches: {launches}, expected {want}")
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    generated = torch.cat(generated, dim=1)
    check(generated.shape == (LM_BATCH, DECODE_NEW)
          and bool(((generated >= 0) & (generated < cfg.vocab_size)).all()),
          "greedy tokens out of the vocabulary")
    decode = {
        "batch": LM_BATCH, "cache_slots": DECODE_SLOTS,
        "prompt_tokens": DECODE_PROMPT, "new_tokens": DECODE_NEW,
        "prompt_ms_per_token": 1e3 * (t1 - t0) / DECODE_PROMPT,
        "new_ms_per_token": 1e3 * (t2 - t1) / DECODE_NEW,
        "ms_per_token": 1e3 * (t2 - t0) / steps,
        "weights_gb": weight_bytes / 1e9, "cache_gb": cache_bytes / 1e9,
        # the code reads every weight once a step (an MoE step too: at
        # its C = 1 every expert runs); the einsum over the cache also
        # reads all its slots (masked past the filled ones)
        "bound_ms_weights": 1e3 * weight_bytes / peaks["bytes"],
        "bound_ms_weights_and_cache":
            1e3 * (weight_bytes + cache_bytes) / peaks["bytes"],
        "first_generated": generated[0, :8].tolist(),
    }
    own = f"_{cfg.moe_dispatch}" if cfg.moe else ""
    bf16_routes = _rel_err(logits_of["flash" + own],
                           logits_of["einsum" + own])
    # where the time goes, after the counters were read: one flash
    # prefill and one decode step under the profiler
    profiles = {
        "prefill_flash" + own: step_profile(
            lambda: T.prefill(params, tokens, cfg, attn_impl="flash"),
            prefill["prefill_flash" + own]["median_s"]),
        "decode_step": step_profile(
            lambda: T.decode_step(params, cache, tok, steps, cfg),
            decode["new_ms_per_token"] / 1e3)}
    # what a decode step needs: the same tokens replayed (the same
    # computation) to count the experts each step routes to; the weights
    # they and the rest of the LM read, the step's token rows, and the
    # cache's filled slots read and one written
    slot_bytes = cache_bytes / DECODE_SLOTS
    needed, used_steps = [], []
    for t, tk in enumerate(fed):
        with recorded_routes() as routed:
            T.decode_step(params, cache, tk, t, cfg)
        used = kept_and_used(routed)[1]
        used_steps.append(used)
        needed.append(needed_weight_bytes(params, cfg, LM_BATCH, used)
                      + (t + 2) * slot_bytes)
    decode["bound_ms"] = 1e3 * statistics.mean(needed) / peaks["bytes"]
    decode["bound_by"] = "bytes"
    route_ms = None
    if cfg.moe:
        decode["experts_used_per_layer"] = (statistics.mean(used_steps)
                                            / cfg.n_layers)
        # one router call at the prefill's grouped shape, after the
        # counters were read (it launches ``topk``)
        xg = torch.randn(G, gs, cfg.d_model, device=dev).to(
            params["tok_embed"].dtype)
        gate = params["layers"]["moe"]["gate"][0]
        route_ms = time_ms(lambda: moe_route(gate, xg, cfg.moe_top_k, C),
                           iters=20)
        del xg
    del cache, logits, logits_of

    # fp32 checks on the same weights (bf16 values are exact in fp32)
    n32 = check_layers or cfg.n_layers
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=n32)
    p32 = T.tree_map(lambda x: x.float(), dict(
        params, layers=T.tree_map(lambda x: x[:n32], params["layers"])))
    del params
    torch.cuda.empty_cache()
    with recorded_routes() as ra:
        fl32 = T.prefill(p32, tokens, cfg32, attn_impl="flash")
    with recorded_routes() as rb:
        ei32 = T.prefill(p32, tokens, cfg32, attn_impl="einsum")
    prefill_rel = _rel_err(fl32, ei32)
    checks = {"fp32_layers": n32, "fp32_prefill_flash_vs_einsum_rel":
              prefill_rel}
    if cfg.moe:
        checks["fp32_routes_flash_vs_einsum"] = route_agreement(
            ra, rb, cfg.moe_top_k, "fp32 prefill, flash vs einsum route")
    check(prefill_rel <= 1e-4, f"fp32 prefill, flash vs einsum route: "
          f"{prefill_rel} of the largest |logit| ({checks})")
    if cfg.moe:
        other = "scatter" if cfg.moe_dispatch == "einsum" else "einsum"
        with recorded_routes() as rc:
            oth32 = T.prefill(p32, tokens, dataclasses.replace(
                cfg32, moe_dispatch=other), attn_impl="einsum")
        checks["fp32_dispatch_modes_rel"] = _rel_err(oth32, ei32)
        checks["fp32_routes_dispatch_modes"] = route_agreement(
            rc, rb, cfg.moe_top_k, "fp32 prefill, dispatch modes")
        check(checks["fp32_dispatch_modes_rel"] <= 1e-5,
              f"fp32 prefill, {other} vs {cfg.moe_dispatch} dispatch: "
              f"{checks}")
    else:
        prompt = tokens[:, :DECODE_PROMPT]
        full, _ = T.forward(p32, prompt, cfg32)
        cache32 = T.init_cache(cfg32, LM_BATCH, DECODE_SLOTS, device="cuda")
        per_step = []
        for t in range(DECODE_PROMPT):
            out, cache32 = T.decode_step(p32, cache32, prompt[:, t:t + 1],
                                         t, cfg32)
            per_step.append(out[:, 0])
        decode_rel = _rel_err(torch.stack(per_step, dim=1), full)
        check(decode_rel <= 1e-4, f"fp32 decode vs forward: {decode_rel} "
              f"of the largest |logit|")
        checks["fp32_decode_vs_forward_rel"] = decode_rel
        del cache32
    del p32
    torch.cuda.empty_cache()
    moe = {}
    if cfg.moe:
        moe = {"experts": cfg.n_experts, "top_k": cfg.moe_top_k,
               "d_ff": cfg.d_ff, "prefill_groups": G, "group_size": gs,
               "capacity": C, "modes": list(modes),
               "route_ms_per_layer": route_ms}
    return {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
        "dtype": cfg.dtype, **moe, "params": n_params,
        # the config's count also holds d for the final norm, which
        # OLMo's non-parametric LN does not have
        "config_n_params": cfg.n_params(),
        "init_s": init_s, "init_peak_gb": init_peak_gb,
        "batch": LM_BATCH, "seq": LM_SEQ, **prefill,
        "prefill_bf16_flash_vs_einsum_rel": bf16_routes,
        "decode": decode, "launches": launches, "profiles": profiles,
        **checks,
    }


def moe_path(ops, peaks):
    """The MoE LMs served on the card through ``lm_path``, each prefilled
    in both dispatch modes with fp32 checks at ``MOE_CHECK_LAYERS``
    layers: moonshot-v1-16b-a3b at full width with
    ``MOE_MOONSHOT_LAYERS`` of its 48 layers, and dbrx-132b at full width
    with ``MOE_DBRX_LAYERS`` of its 40 layers."""
    import torch
    models = {}
    for arch, n_layers in MOE_ARCHS:
        over = {} if n_layers is None else {"n_layers": n_layers}
        models[arch] = lm_path(ops, peaks, lm_config(arch, **over),
                               check_layers=MOE_CHECK_LAYERS)
        torch.cuda.empty_cache()
    launches = {k: sum(m["launches"][k] for m in models.values())
                for k in ops.LAUNCHES}
    return {"models": models, "launches": launches}


# ---------------------------------------------------------------------------
# phase 3: LM training (the entry point at full width; resume, preemption)
# ---------------------------------------------------------------------------

def train_step_work(cfg, batch, seq, kept=None):
    """(bf16 tensor-core FLOP, fp32 FLOP) of one training step of
    ``batch`` x ``seq`` tokens, from the code: the weight products run
    forward, again under remat, and backward (two products), 8 FLOP per
    weight and token; the tied head in fp32 (``_logits``; TF32 off), not
    recomputed, 6 per weight and token; the QK^T einsum (fp32) and the PV
    product (bf16) over the full masked S^2, each a product of 2 S^2 d
    FLOP per sequence and layer, in 4 passes (forward, remat forward, and
    the two products of the backward); 3 passes without remat. An MoE
    config's FFN instead: the fp32 router, 2 D E FLOP a token and layer,
    and the experts' three products over the ``kept`` (token, choice)
    pairs of one forward summed over its layers (``kept_and_used``), 6 D
    F FLOP each, in as many passes."""
    tokens = batch * seq
    n_mat = 0 if cfg.moe else 3 if cfg.mlp_act == "swiglu" else 2
    weights = cfg.n_layers * (cfg._per_layer_attn()
                              + n_mat * cfg.d_model * cfg.d_ff)
    passes = 4 if cfg.remat else 3
    per_pass = 2 * batch * seq * seq * cfg.n_heads * cfg.head_dim \
        * cfg.n_layers
    weight_flop = (passes * 2) * weights * tokens
    head_flop = 6 * cfg.vocab_size * cfg.d_model * tokens
    bf16, fp32 = (weight_flop + passes * per_pass,
                  head_flop + passes * per_pass)
    if cfg.moe:
        bf16 += passes * 6 * cfg.d_model * cfg.d_ff * kept
        fp32 += passes * 2 * tokens * cfg.d_model * cfg.n_experts \
            * cfg.n_layers
    return bf16, fp32


def _kernel_category(name: str) -> str:
    """A device kernel's kind by its name. cuBLAS names its Hopper
    tensor-core kernels ``nvjet_*`` without a dtype; with TF32 off, the
    fp32 products run as ``*f32*``/``*sgemm*`` kernels on the FMA units."""
    n = name.lower()
    if "nvjet" in n or ("gemm" in n and "bf16" in n):
        return "matmul_tensor_core"
    if any(k in n for k in ("gemm", "xmma", "cutlass")):
        return "matmul_fp32"
    for cat, keys in (("softmax", ("softmax",)),
                      ("reduce", ("reduce", "norm")),
                      ("index", ("index", "scatter", "gather", "embedding")),
                      ("cat_copy", ("cat", "copy", "memcpy", "memset")),
                      ("elementwise", ("elementwise", "vectorized",
                                       "unrolled"))):
        if any(k in n for k in keys):
            return cat
    return "other"


def step_profile(fn, step_s):
    """One call of ``fn`` under ``torch.profiler`` (device activity only):
    the device time by kernel category and the 12 costliest kernels, and
    the device's idle share against ``step_s``, an unprofiled step's
    synchronised wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0.0) > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    cats = {}
    for e in events:
        c = _kernel_category(e.key)
        cats[c] = cats.get(c, 0.0) + e.self_device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    return {"device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / (1e3 * step_s)),
            "ms_by_category": dict(sorted(cats.items(),
                                          key=lambda kv: -kv[1])),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def train_path(ops, peaks):
    """olmo-1b trained on the card through ``repro_torch.launch.train``'s
    ``main`` at full width and depth (``TRAIN_STEPS`` steps of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens in ``TRAIN_MB`` micro-batches,
    bf16, remat on). ``make_train_step`` is wrapped so that each step runs
    between two synchronisations of the card: the device ms/step is the
    median of steps 3 to ``TRAIN_STEPS``, apart from the loop's own host
    ``step_time_s``; ``transformer.init`` is timed likewise. The launch
    counters are zeroed before and must all read 0 after: the training
    path computes attention on the einsum route, as the JAX package's
    ``loss_fn`` does, so it launches none of the six kernels. After the
    run, one more step on the last step's arguments runs under the
    profiler (``step_profile``) for the breakdown."""
    import math
    import statistics
    import torch
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as T
    from repro_torch.train import train_loop

    cfg = lm_config()
    walls, init_s, last = [], [], {}
    make, init = train_loop.make_train_step, T.init

    def synced(fn, out, keep=False):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
            if keep:                     # the step to profile afterwards
                last.update(fn=fn, args=a)
            return r
        return wrapper

    argv = ["--arch", LM_ARCH, "--full", "--steps", str(TRAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--microbatches", str(TRAIN_MB), "--device", "cuda"]
    train_loop.make_train_step = lambda *a, **k: synced(make(*a, **k),
                                                        walls, keep=True)
    T.init = synced(init, init_s)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        report = launch.main(argv)
    finally:
        train_loop.make_train_step, T.init = make, init
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(sum(launches.values()) == 0,
          f"the training path launched a kernel: {launches}")
    check(len(walls) == TRAIN_STEPS, f"{len(walls)} timed steps")
    hist = report["history"]
    first, last_loss = hist[0]["loss"], hist[-1]["loss"]
    check(hist[0]["step"] == 1 and hist[-1]["step"] == TRAIN_STEPS
          and math.isfinite(first) and math.isfinite(last_loss)
          and last_loss <= first, f"training losses {first} -> {last_loss}")
    med = statistics.median(walls[2:])
    profiled = step_profile(lambda: last["fn"](*last["args"]), med)
    last.clear()
    torch.cuda.empty_cache()
    bf16_flop, fp32_flop = train_step_work(cfg, TRAIN_BATCH, TRAIN_SEQ)
    bound_s = bf16_flop / peaks["bf16_tc"] + fp32_flop / peaks["fp32"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return {
        "argv": argv, "arch": cfg.name, "params": report["params"],
        "dtype": cfg.dtype, "remat": cfg.remat,
        "remat_policy": cfg.remat_policy, "init_s": init_s[0],
        "device_ms_per_step": 1e3 * med,
        "device_ms_per_step_all": [1e3 * w for w in walls],
        "host_step_time_ms": [1e3 * h["step_time_s"] for h in hist],
        "tokens_per_step": tokens, "tokens_per_s": tokens / med,
        "bf16_tflop_per_step": bf16_flop / 1e12,
        "fp32_tflop_per_step": fp32_flop / 1e12,
        "achieved_tflop_per_s": (bf16_flop + fp32_flop) / med / 1e12,
        "bound_ms_per_step": 1e3 * bound_s, "bound_by": "operations",
        "bound_share": bound_s / med,
        "peak_memory_gb": peak / 1e9,
        "losses": [(h["step"], h["loss"]) for h in hist],
        "first_loss": first, "last_loss": last_loss, "launches": launches,
        "profiled_step": profiled,
    }


class FakePreemption:
    """A ``PreemptionHandler`` that installs nothing; the hook of
    ``train_resume`` sets ``triggered`` at a chosen step."""
    last = None

    def __init__(self, *a, **k):
        self.triggered = False
        FakePreemption.last = self

    def restore(self):
        pass


def train_resume():
    """olmo-1b's width with ``RESUME_LAYERS`` layers, bf16, 2 micro-batches
    and int8 error feedback, in a temporary directory: the same 3 steps
    twice give the same parameters (the card is deterministic here, which
    the next check needs); 6 steps uninterrupted against 3 steps with
    ``ckpt_every=3`` and a fresh ``train(..., resume=True)`` to 6: equal
    parameters, bit for bit; a bf16 leaf restored bit for bit; a fake
    preemption at step 2 writes a ``preempted`` checkpoint and returns.
    Then the restore and the write of one checkpoint are timed."""
    import torch
    from repro_torch.launch.train import lm_data
    from repro_torch.models import transformer as T
    from repro_torch.train import CheckpointManager, OptConfig, TrainConfig
    from repro_torch.train import train_loop
    from repro_torch.train.train_loop import param_leaves, train

    cfg = lm_config(n_layers=RESUME_LAYERS)
    ocfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=6)

    def run(steps, ckpt=None, hooks=(), **kw):
        params = T.init(cfg, seed=0, device="cuda")
        return train(lambda p, b: T.loss_fn(p, b["tokens"], b["labels"],
                                            cfg),
                     params, lm_data(cfg, RESUME_BATCH, RESUME_SEQ,
                                     device="cuda"),
                     ocfg, TrainConfig(steps=steps, log_every=1,
                                       n_microbatches=2,
                                       compression="int8_ef", **kw),
                     ckpt=ckpt, hooks=hooks)

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(param_leaves(a),
                                                     param_leaves(b)))

    repeat = equal(run(3)[0], run(3)[0])
    check(repeat, "the same 3 training steps gave other parameters")
    want, whist = run(6)
    n_params = sum(x.numel() for x in param_leaves(want))
    out = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "batch": RESUME_BATCH, "seq": RESUME_SEQ,
           "repeat_bitwise": repeat}
    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(os.path.join(d, "resume"), keep=2)
        run(3, ckpt, ckpt_every=3)
        check(ckpt.all_steps() == [3], f"checkpoints {ckpt.all_steps()}")
        got, hist = run(6, ckpt)
        check([h["step"] for h in hist] == [4, 5, 6]
              and [h["loss"] for h in hist]
              == [h["loss"] for h in whist[3:]],
              "the resumed run's losses differ from the uninterrupted's")
        check(equal(got, want), "resume from step 3 differs from 6 steps "
              "uninterrupted")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, tree, extra = ckpt.restore(device="cuda")
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        emb = tree[0]["tok_embed"]
        check(step == 6 and emb.dtype == torch.bfloat16
              and torch.equal(emb.view(torch.int16),
                              got["tok_embed"].view(torch.int16)),
              "the bf16 embedding did not restore bit for bit")
        t0 = time.perf_counter()
        ckpt.save(7, tree, extra=extra)
        ckpt.wait()
        out["write_s"] = time.perf_counter() - t0
        out["checkpoint_gb"] = os.path.getsize(os.path.join(
            ckpt.dir, "step_00000007", "leaves.npz")) / 1e9
        del tree, emb

        handler = train_loop.PreemptionHandler
        train_loop.PreemptionHandler = FakePreemption
        try:
            pre = CheckpointManager(os.path.join(d, "preempt"))

            def preempt_at_2(m):
                if m["step"] == 2:
                    FakePreemption.last.triggered = True

            _, phist = run(6, pre, hooks=[preempt_at_2])
        finally:
            train_loop.PreemptionHandler = handler
        step, _, extra = pre.restore(device="cpu")
        check(step == 2 and extra.get("preempted") is True
              and phist[-1]["step"] == 2,
              f"preemption: checkpoint {step} {extra}")
    out.update(resume_bitwise=True, resumed_steps=[4, 5, 6],
               preempted_at=2, losses=[h["loss"] for h in whist])
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3: the step builders (repro_torch.launch.steps) at full width
# ---------------------------------------------------------------------------

def _synced(fn):
    """``fn()`` between two synchronisations of the card: (result, s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _cut(cell, **kw):
    """``cell`` with ``kw`` replaced, and the cut as {field: [was, now]}."""
    import dataclasses
    return (dataclasses.replace(cell, **kw),
            {k: [getattr(cell, k), v] for k, v in kw.items()})


def _lm_tokens(cfg, B, S, seed, dev):
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(0, cfg.vocab_size, (B, S),
                                       dtype=np.int32)).to(dev)


def _launches_since(ops, before):
    return {k: ops.LAUNCHES[k] - before[k] for k in before}


def _bound(work, nbytes, peaks):
    """``{"bound_ms", "bound_by"}``: the larger of ``work`` (categories of
    (bf16, fp32) FLOP) at the peak rates and ``nbytes`` at the memory
    rate."""
    op_s, by_s = work_s(work, peaks), nbytes / peaks["bytes"]
    return {"bound_ms": 1e3 * max(op_s, by_s),
            "bound_by": "operations" if op_s >= by_s else "bytes"}


def steps_train_cell(ops, peaks, cfg, cell, cut, policies, n_steps):
    """``cell`` through ``steps.build_lm`` under each remat policy in
    ``policies``: ``n_steps`` steps from ``transformer.init(cfg, seed=0)``
    (restored bit for bit before each policy) on the same seeded batches,
    each step between two synchronisations of the card; per policy the
    ms/step (median of steps 2 to N), peak GB, the launches and one more
    step under the profiler (idle share); the losses and the final
    parameters bitwise equal under every policy. The bound: the larger
    of ``train_step_work`` without remat's recompute (3 passes; for MoE
    on the kept choices of the first batch, counted in a forward of its
    micro-batches without gradients) and ``train_bytes``."""
    import dataclasses
    import math
    import statistics
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import param_leaves

    params, init_s = _synced(lambda: T.init(cfg, seed=0, device="cuda"))
    leaves = param_leaves(params)
    base = [t.to("cpu", copy=True) for t in leaves]        # host copies
    B, S = cell.global_batch, cell.seq_len
    n_mb = max(1, cfg.train_microbatches)
    batches = []
    for i in range(n_steps):
        toks = _lm_tokens(cfg, B, S + 1, 100 + i, leaves[0].device)
        batches.append({"tokens": toks[:, :-1].contiguous(),
                        "labels": toks[:, 1:].contiguous()})
    kept = None
    if cfg.moe:
        with torch.no_grad(), recorded_routes() as routed:
            for i in range(n_mb):
                rows = batches[0]["tokens"][i * B // n_mb:
                                            (i + 1) * B // n_mb]
                T.forward(params, rows, cfg)
        kept = kept_and_used(routed)[0]
    out = {"cell": f"{cfg.name}:{cell.name}", "cut": cut,
           "layers": cfg.n_layers, "params": sum(t.numel() for t in leaves),
           "init_s": init_s, "batch": B, "seq": S, "microbatches": n_mb,
           "steps": n_steps, "kept_choices": kept, "policies": {}}
    want = None
    for policy in policies:
        spec = steps.build_lm(dataclasses.replace(cfg, remat_policy=policy),
                              cell)
        with torch.no_grad():
            for t, b in zip(leaves, base):
                t.copy_(b)
        state = opt.init(leaves)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = dict(ops.LAUNCHES)
        walls, losses = [], []
        for b in batches:
            (_, _, loss), w = _synced(lambda: spec.fn(params, state, b))
            walls.append(w)
            losses.append(float(loss))
        launches = _launches_since(ops, before)
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(all(math.isfinite(x) for x in losses),
              f"{out['cell']} {policy}: losses {losses}")
        per_call = cfg.n_layers * n_mb * (2 if cfg.remat else 1)
        want_l = {"topk": per_call * n_steps if cfg.moe else 0}
        check(all(launches[k] == want_l.get(k, 0) for k in launches),
              f"{out['cell']} {policy} launched {launches}, expected "
              f"{want_l}")
        final = [t.to("cpu", copy=True) for t in leaves]
        if want is None:
            want = (losses, final)
        else:
            check(losses == want[0]
                  and all(torch.equal(a, b) for a, b in zip(final, want[1])),
                  f"{out['cell']}: remat {policy} differs from "
                  f"{policies[0]}: losses {losses} against {want[0]}")
        del final
        med = statistics.median(walls[1:])
        profiled = step_profile(lambda: spec.fn(params, state, batches[0]),
                                med)
        del state
        torch.cuda.empty_cache()
        out["policies"][policy] = {
            "ms_per_step": 1e3 * med,
            "ms_per_step_all": [1e3 * w for w in walls],
            "tokens_per_s": B * S / med, "peak_memory_gb": peak,
            "losses": losses, "launches": launches,
            "idle_share": profiled["idle_share"],
            "device_busy_ms": profiled["device_busy_ms"],
            "ms_by_category": profiled["ms_by_category"]}
    if len(policies) > 1:
        out["policies_bitwise_equal"] = True
    bf16, fp32 = train_step_work(dataclasses.replace(cfg, remat=False),
                                 B, S, kept)
    out.update(_bound({"step": (bf16, fp32)},
                      train_bytes(out["params"], 2), peaks))
    out["code_tflop_per_step"] = sum(train_step_work(cfg, B, S, kept)) / 1e12
    del params, leaves, base
    torch.cuda.empty_cache()
    return out


def steps_prefill_cell(ops, peaks, cfg, params, cell, cut, seed):
    """``cell`` through ``steps.build_lm`` on seeded prompts: a warm-up and
    ``STEPS_PREFILL_CALLS`` timed calls (median), each launching
    ``flash_attention`` once per layer per batch chunk (the long-prefill
    recipe's halves at d_model >= 6144 and S >= 32768) and no other
    kernel; the logits finite; peak GB; one call profiled; the bound from
    the function (``prefill_work``, ``needed_weight_bytes``)."""
    import statistics
    import torch
    from repro_torch.launch import steps

    B, S = cell.global_batch, cell.seq_len
    spec = steps.build_lm(cfg, cell)
    chunks = _prefill_chunks(cfg, B, S)
    tokens = _lm_tokens(cfg, B, S, seed, params["tok_embed"].device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(STEPS_PREFILL_CALLS + 1):
        before = dict(ops.LAUNCHES)
        logits, w = _synced(lambda: spec.fn(params, tokens))
        n = _launches_since(ops, before)
        want = {"flash_attention": cfg.n_layers * chunks}
        check(all(n[k] == want.get(k, 0) for k in n),
              f"{spec.name} launched {n}, expected {want}")
        if i:
            walls.append(w)
    check(logits.shape == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{spec.name} logits {tuple(logits.shape)} not finite")
    med = statistics.median(walls)
    peak = torch.cuda.max_memory_allocated() / 1e9
    profiled = step_profile(lambda: spec.fn(params, tokens), med)
    rows = int(torch.unique(tokens).numel())
    out = {"cell": spec.name, "cut": cut, "layers": cfg.n_layers,
           "batch": B, "seq": S, "batch_chunks": chunks,
           "launches_per_call": n, "ms": 1e3 * med,
           "ms_all": [1e3 * w for w in walls], "tokens_per_s": B * S / med,
           "peak_memory_gb": peak, "idle_share": profiled["idle_share"],
           "ms_by_category": profiled["ms_by_category"],
           "top_kernels": profiled["top_kernels"][:4],
           **_bound(prefill_work(cfg, B, S),
                    needed_weight_bytes(params, cfg, rows), peaks)}
    del logits, tokens
    torch.cuda.empty_cache()
    return out


def steps_decode_cell(ops, peaks, cfg, params, spec, cut, seed, window=0):
    """``STEPS_DECODE_STEPS`` steps of ``spec`` (a built decode step) on a
    cache of the cell's length filled with seeded normals, at its last
    positions (a window variant's, built with ``window``, past it), each
    between two
    synchronisations (median of steps 2 to N); the logits finite; no
    kernel launched; the bound: the function's bytes a step (the weights
    it reads, the cache slots its attention reads: all filled ones, or
    the window's, and the slot it writes), beside them the code's (every
    weight and the whole cache)."""
    import statistics
    import torch
    from repro_torch.models import transformer as T

    token_shape = spec.args[2].shape
    B, S = token_shape[0], spec.args[1]["k"].shape[2]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = params["tok_embed"].device
    cache = T.init_cache(cfg, B, S, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for x in cache.values():
        x.normal_(generator=g)
    toks = _lm_tokens(cfg, B, STEPS_DECODE_STEPS, seed, dev)
    start = S - STEPS_DECODE_STEPS
    before = dict(ops.LAUNCHES)
    walls = []
    for t in range(STEPS_DECODE_STEPS):
        (logits, cache), w = _synced(lambda: spec.fn(
            params, cache, toks[:, t:t + 1], start + t))
        walls.append(w)
    launches = _launches_since(ops, before)
    check(sum(launches.values()) == 0,
          f"{spec.name} decode launched {launches}")
    check(logits.shape == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{spec.name} decode logits not finite")
    med = statistics.median(walls[1:])
    cache_bytes = sum(x.numel() * x.element_size() for x in cache.values())
    slot = cache_bytes / S
    read = [min(start + t + 1, window or S)
            for t in range(STEPS_DECODE_STEPS)]
    nbytes = (needed_weight_bytes(params, cfg, B)
              + (statistics.mean(read) + 1) * slot)
    out = {"cell": spec.name, "cut": cut, "layers": cfg.n_layers,
           "batch": B, "cache_slots": S, "window": window,
           "positions": [start, start + STEPS_DECODE_STEPS - 1],
           "cache_gb": cache_bytes / 1e9, "ms_per_token": 1e3 * med,
           "ms_per_token_all": [1e3 * w for w in walls],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           **_bound({}, nbytes, peaks),
           "code_bytes_ms": 1e3 * (tree_bytes(params) + cache_bytes)
           / peaks["bytes"]}
    del cache, logits
    torch.cuda.empty_cache()
    return out


def steps_path(ops, peaks):
    """The LM cells of ``repro_torch.launch.steps`` on the card at full
    width in bf16, built with ``steps.build_lm``/``build_lm_long_window``
    (every global batch cut to one card, each cut printed) and run on
    parameters from ``transformer.init(cfg, seed=0)`` and seeded data:
    olmo-1b's train_4k at batch ``STEPS_TRAIN_BATCH`` under the remat
    policies ``nothing``, ``dots_nobatch`` and ``dots`` (bitwise equal),
    prefill_32k at batch ``STEPS_PREFILL_BATCH`` (the serve step's flash
    route: 16 ``flash_attention`` launches a call), decode_32k, and
    long_500k (its ``skip_reason``, then the window variant's decode with
    its cache cut to ``STEPS_WINDOW_SLOTS``); granite-34b with
    ``STEPS_GRANITE_LAYERS`` layers (prefill_32k through the long-prefill
    recipe: 2 halves, 8 launches a call; decode_32k); moonshot-v1-16b-a3b
    with ``STEPS_MOE_LAYERS`` layers, train_4k at batch
    ``STEPS_MOE_BATCH`` in its config's micro-batches (``topk`` once per
    layer per micro-batch, twice under remat). The launch counters are
    zeroed before and read after: ``flash_attention`` and ``topk`` must
    have launched. ``long_prefill_checks`` holds the prefill cells'
    kernel and route against references after the counters are read."""
    import torch
    from repro_torch.common.config import LM_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    ops.reset_launches()
    cells = []
    t_path = time.perf_counter()

    cfg = lm_config()
    cell, cut = _cut(LM_SHAPES["train_4k"], global_batch=STEPS_TRAIN_BATCH)
    cells.append(steps_train_cell(ops, peaks, cfg, cell, cut,
                                  ("nothing", "dots_nobatch", "dots"),
                                  STEPS_TRAIN_STEPS))
    params = T.init(cfg, seed=0, device="cuda")
    cell, cut = _cut(LM_SHAPES["prefill_32k"],
                     global_batch=STEPS_PREFILL_BATCH)
    cells.append(steps_prefill_cell(ops, peaks, cfg, params, cell, cut, 1))
    cell, cut = _cut(LM_SHAPES["decode_32k"],
                     global_batch=STEPS_DECODE_BATCH[LM_ARCH])
    cells.append(steps_decode_cell(ops, peaks, cfg, params,
                                   steps.build_lm(cfg, cell), cut, 2))
    skipped = steps.build(LM_ARCH, "long_500k")
    check(skipped.fn is None and skipped.skip_reason,
          "long_500k built a full-attention step")
    cell, cut = _cut(LM_SHAPES["long_500k"], seq_len=STEPS_WINDOW_SLOTS)
    window = 8192
    cells.append(dict(steps_decode_cell(
        ops, peaks, cfg, params,
        steps.build_lm_long_window(cfg, cell, window=window), cut, 3,
        window=window), skip_reason=skipped.skip_reason))
    del params
    torch.cuda.empty_cache()

    arch = "granite-34b"
    cfg = lm_config(arch, n_layers=STEPS_GRANITE_LAYERS)
    layers_cut = {"n_layers": [lm_config(arch).n_layers, cfg.n_layers]}
    params, init_s = _synced(lambda: T.init(cfg, seed=0, device="cuda"))
    cell, cut = _cut(LM_SHAPES["prefill_32k"],
                     global_batch=STEPS_PREFILL_BATCH)
    cells.append(dict(steps_prefill_cell(ops, peaks, cfg, params, cell,
                                         dict(cut, **layers_cut), 4),
                      init_s=init_s))
    cell, cut = _cut(LM_SHAPES["decode_32k"],
                     global_batch=STEPS_DECODE_BATCH[arch])
    cells.append(steps_decode_cell(ops, peaks, cfg, params,
                                   steps.build_lm(cfg, cell),
                                   dict(cut, **layers_cut), 5))
    del params
    torch.cuda.empty_cache()

    arch = "moonshot-v1-16b-a3b"
    cfg = lm_config(arch, n_layers=STEPS_MOE_LAYERS)
    cell, cut = _cut(LM_SHAPES["train_4k"], global_batch=STEPS_MOE_BATCH)
    cut["n_layers"] = [lm_config(arch).n_layers, cfg.n_layers]
    cells.append(steps_train_cell(ops, peaks, cfg, cell, cut,
                                  (cfg.remat_policy,), STEPS_MOE_STEPS))
    launches = dict(ops.LAUNCHES)
    check(launches["flash_attention"] > 0 and launches["topk"] > 0,
          f"the steps path's kernels never launched: {launches}")
    return {"cells": cells, "launches": launches,
            "path_s": time.perf_counter() - t_path}


def _prefill_chunks(cfg, B, S):
    """The batch chunks of a built prefill step: the long-prefill recipe's
    halves at d_model >= 6144 and S >= 32768, else one."""
    return 2 if (cfg.prefill_batch_chunks == 0 and cfg.d_model >= 6144
                 and S >= 32768 and B % 2 == 0) else 1


def _flash_plain_blocked(q, k, v, block):
    """The plain version's causal attention, ``ref.flash_attention_ref``'s
    arithmetic (fp32 scores times 1/sqrt(dh), the columns past each row
    masked, softmax, fp32 p.v, cast to q's dtype), one block of ``block``
    query rows at a time against the keys up to the block's end: whole,
    the scores would take B*H*S^2*4 bytes (137 GB at olmo-1b's
    prefill_32k cell)."""
    import math
    import torch
    B, S, H, dh = q.shape
    out = torch.empty_like(q)
    for q0 in range(0, S, block):
        q1 = min(q0 + block, S)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q1].float(),
                         k[:, :q1].float()) * (1.0 / math.sqrt(dh))
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        cols = torch.arange(q1, device=q.device)[None, :]
        w = torch.softmax(s.masked_fill_(cols > rows, -math.inf), dim=-1)
        del s
        out[:, q0:q1] = torch.einsum("bhqk,bkhd->bqhd", w,
                                     v[:, :q1].float()).to(q.dtype)
    return out


def long_prefill_checks(ops, peaks):
    """The steps path's prefill at S = 32768, checked after its launch
    counters were read. For olmo-1b and granite-34b: ``flash_attention``
    at the shape the built prefill step launches it at (olmo-1b's cell,
    B = 2, H = 16; one of granite-34b's halves, B = 1, H = 48, its one
    K/V head repeated; dh = 128, bf16, causal) on seeded normals, against
    the plain version block by block over the queries
    (``_flash_plain_blocked``, 1024 rows a block, the last one included),
    every element within ``check_flash_attention``'s bf16 tolerance (atol
    1e-4, rtol 2**-7); its time (CUDA events over 5 calls, and the
    profiler's device time, None where it records no event) beside the
    blocked plain version's and SDPA's on the (B, H, S, dh) view, and
    ``flash_bound``. Then the built prefill step at the cell
    with ``STEPS_CHECK_LAYERS`` layers in fp32 (weights from
    ``transformer.init(cfg, seed=0)``): its logits, through the flash
    route (``flash_attention`` once per layer per batch chunk), against
    ``transformer.prefill``'s einsum route with 1024-row query blocks (the
    recipe's blocking), one prompt at a time, within ``lm_path``'s 1e-4
    of the largest |logit|."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from repro_torch.common.config import LM_SHAPES
    from repro_torch.common.device import resolve_device
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    dev = resolve_device("cuda")
    kernel, built = [], []
    cell = dataclasses.replace(LM_SHAPES["prefill_32k"],
                               global_batch=STEPS_PREFILL_BATCH)
    B, S = cell.global_batch, cell.seq_len
    for i, arch in enumerate(("olmo-1b", "granite-34b")):
        cfg = lm_config(arch)
        chunks = _prefill_chunks(cfg, B, S)
        shape = (B // chunks, S, cfg.n_heads, cfg.head_dim)
        g = torch.Generator(device=dev).manual_seed(40 + i)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16) for _ in range(3))
        got = ops.flash_attention(q, k, v, causal=True)
        want = _flash_plain_blocked(q, k, v, 1024)
        diff = (got.float() - want.float()).abs()
        bad = int((diff > 1e-4 + 2 ** -7 * want.float().abs()).sum())
        check(bad == 0, f"flash_attention {shape} bf16 against the blocked "
              f"plain version: {bad} elements off, max |diff| "
              f"{float(diff.max())}")
        max_err = float(diff.max())
        del got, want, diff
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bound = flash_bound(q, peaks)
        ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True),
                     iters=5, warmup=2)
        dev_ms, events = device_ms(
            lambda: ops.flash_attention(q, k, v, causal=True), iters=3,
            capturable=False)
        kernel.append({
            "arch": arch, **bound, "batch_chunks": chunks,
            "max_abs_err": max_err, "atol": 1e-4, "rtol": 2 ** -7,
            "ms": ms, "device_ms": dev_ms, "device_events_per_call": events,
            "plain": "blocked over 1024 query rows",
            "plain_ms": time_ms(lambda: _flash_plain_blocked(q, k, v, 1024),
                                iters=1, warmup=0),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), iters=5, warmup=2),
            "library_device_ms": device_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), iters=3)[0],
            "tensor_tflops": bound["tensor_gflop"] / (dev_ms or ms),
            "bound_share": bound["bound_ms"] / (dev_ms or ms)})
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

        cfg32 = lm_config(arch, n_layers=STEPS_CHECK_LAYERS,
                          dtype="float32")
        params = T.init(cfg32, seed=0, device=dev)
        tokens = _lm_tokens(cfg32, B, S, 50 + i, dev)
        spec = steps.build_lm(cfg32, cell)
        before = dict(ops.LAUNCHES)
        got, flash_s = _synced(lambda: spec.fn(params, tokens))
        n = _launches_since(ops, before)
        check(n["flash_attention"] == STEPS_CHECK_LAYERS * chunks,
              f"{spec.name} fp32 launched {n}")
        ecfg = dataclasses.replace(cfg32, attn_q_chunk=1024)
        want, einsum_s = _synced(lambda: torch.cat([
            T.prefill(params, tokens[b:b + 1], ecfg, attn_impl="einsum")
            for b in range(B)]))
        rel = _rel_err(got, want)
        check(rel <= 1e-4, f"{spec.name} fp32 at {STEPS_CHECK_LAYERS} "
              f"layers, the flash route against the einsum route with "
              f"1024-row query blocks: {rel} of the largest |logit|")
        built.append({"cell": spec.name, "layers": STEPS_CHECK_LAYERS,
                      "dtype": "float32", "batch": B, "seq": S,
                      "batch_chunks": chunks, "launches": n,
                      "flash_vs_einsum_rel": rel, "tolerance": 1e-4,
                      "flash_s": flash_s, "einsum_s": einsum_s})
        del params, tokens, got, want
        torch.cuda.empty_cache()
    return {"flash_attention": kernel, "prefill_fp32": built}


# ---------------------------------------------------------------------------
# phase 3: the vision and diffusion models (ViT, DeiT, DiT, EfficientNet)
# ---------------------------------------------------------------------------

def vision_config(arch, **overrides):
    """The full-width config of a vision or DiT arch (its config's bf16)."""
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch), **overrides)


def vit_work(cfg, batch, res, code=False):
    """The work of one ViT/DeiT forward of ``batch`` images at ``res`` by
    category, each (bf16 tensor-core FLOP, fp32 FLOP), as
    ``prefill_work`` counts it. The function's (``code`` False): the patch
    embedding, per layer the four attention projections and the two MLP
    products (2 FLOP per weight and token), q.k^T and p.v over all T^2
    token pairs, and the head(s) on the CLS (and distillation) token,
    every product on the bf16 tensor cores (the JAX package computes
    q.k^T as a bf16 product with fp32 results). The code's (``code``
    True): the same with q.k^T in fp32, since the einsum route widens q
    and k to fp32 (TF32 off)."""
    D, L = cfg.d_model, cfg.n_layers
    n_p = (res // cfg.patch) ** 2
    T = cfg.n_tokens(res)
    heads = 2 if cfg.distill_token else 1
    qk = batch * L * 2 * T * T * D
    return {"patch": (batch * 2 * n_p * cfg.patch ** 2 * cfg.in_channels
                      * D, 0),
            "layers": (batch * L * 2 * T * (4 * D * D + 2 * D * cfg.d_ff),
                       0),
            "attention": (qk, qk) if code else (2 * qk, 0),
            "head": (batch * heads * 2 * D * cfg.n_classes, 0)}


def dit_work(cfg, batch, img_res, code=False):
    """The work of one DiT forward of ``batch`` latents of ``img_res / 8``
    pixels a side (N tokens) by category, as ``vit_work`` counts it: the
    patch embedding, the timestep MLP, per layer the adaLN product, the
    projections and the MLP, q.k^T and p.v over N^2 pairs (q.k^T in fp32
    with ``code``), the final adaLN and output products."""
    D, L, N = cfg.d_model, cfg.n_layers, cfg.n_tokens(img_res)
    p2c = cfg.patch ** 2 * cfg.latent_channels
    qk = batch * L * 2 * N * N * D
    return {"embed": (batch * (2 * N * p2c * D + 2 * (256 * D + D * D)), 0),
            "layers": (batch * L * (2 * D * 6 * D
                                    + 2 * N * (4 * D * D + 2 * D * cfg.d_ff)),
                       0),
            "attention": (qk, qk) if code else (2 * qk, 0),
            "final": (batch * (2 * D * 2 * D + 2 * N * D * 2 * p2c), 0)}


def effnet_work(cfg, batch, res, code=False):
    """The work of one EfficientNet forward: the model's own analytic count
    (``flops_per_image``), every convolution and product at the bf16
    tensor-core rate; the code computes the same."""
    from repro_torch.models import efficientnet as E
    return {"convs": (batch * E.flops_per_image(cfg, res), 0)}


def vision_bound(work, nbytes, peaks, passes=1, code_passes=None):
    """The bound of ``passes`` times the function's ``work`` (a ``*_work``
    function of (code,)), the larger of its operations at the card's
    peak rates and ``nbytes`` at its memory rate: ``{"bound_ms",
    "bound_by", "tflop"}``, one bound per model. Beside it the code's
    extra work as ms at peak (``code_extra_ms_at_peak``): a category the
    code computes at a slower precision, over ``passes``, and
    ``remat_recompute``, the forward that ``code_passes`` (remat: 4)
    runs beyond ``passes`` (a training step: 3)."""
    fn, code = work(False), work(True)
    code_passes = code_passes or passes
    ops_s = passes * work_s(fn, peaks)
    bytes_s = nbytes / peaks["bytes"]
    extra = {k: 1e3 * passes * (work_s({k: v}, peaks)
                                - work_s({k: fn[k]}, peaks))
             for k, v in code.items() if v != fn[k]}
    if code_passes > passes:
        extra["remat_recompute"] = (1e3 * (code_passes - passes)
                                    * work_s(code, peaks))
    return {"bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "tflop": passes * sum(b + f for b, f in fn.values()) / 1e12,
            "code_tflop": code_passes * sum(b + f for b, f in code.values())
            / 1e12,
            "code_extra_ms_at_peak": extra}


def tree_bytes(tree):
    return sum(x.numel() * x.element_size() for x in _flat_tree(tree))


def train_bytes(n_params, param_bytes):
    """The least bytes of a training step: each weight read and written,
    its fp32 gradient written and read, AdamW's two fp32 moments read and
    written."""
    return n_params * (2 * param_bytes + 2 * 4 + 4 * 4)


def synced_train(ops, argv, init_fn):
    """``repro_torch.launch.train.main(argv)`` on the card, each step
    between two synchronisations of the card (``make_train_step``
    wrapped) and the model's ``init`` (``init_fn``, a (module, name)
    pair) timed likewise: ``(report, init_s, step walls s, peak bytes,
    launches)``, the launch counters as they stand after it."""
    import torch
    from repro_torch.launch import train as launch
    from repro_torch.train import train_loop

    walls, init_s = [], []
    make = train_loop.make_train_step
    mod, name = init_fn
    init = getattr(mod, name)

    def synced(fn, out):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
            return r
        return wrapper

    train_loop.make_train_step = lambda *a, **k: synced(make(*a, **k),
                                                        walls)
    setattr(mod, name, synced(init, init_s))
    torch.cuda.reset_peak_memory_stats()
    try:
        report = launch.main(argv)
    finally:
        train_loop.make_train_step = make
        setattr(mod, name, init)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return report, init_s[0], walls, peak, dict(ops.LAUNCHES)


def train_entry(ops, peaks, arch, batch, steps, init_fn, work, extra=()):
    """One arch trained through the entry point at full width (``--full
    --batch B --steps N``): device ms/step (median of steps 2 to N), the
    loss finite at every logged step, its bound (3 x the function's
    forward ``work``, a forward and a backward of twice its work;
    ``train_bytes``) with the code's extra work beside it (remat runs a
    fourth pass), peak memory, and no kernel launched since the vision
    path began."""
    import math
    import statistics
    argv = ["--arch", arch, "--full", "--steps", str(steps), "--batch",
            str(batch), "--device", "cuda", *extra]
    report, init_s, walls, peak, launches = synced_train(ops, argv,
                                                         init_fn)
    cfg = vision_config(arch)
    check(sum(launches.values()) == 0,
          f"{arch} training launched a kernel: {launches}")
    hist = report["history"]
    check(len(walls) == steps and hist[-1]["step"] == steps
          and all(math.isfinite(h["loss"]) for h in hist),
          f"{arch} training: {[(h['step'], h['loss']) for h in hist]}")
    med = statistics.median(walls[1:])
    # EfficientNet checkpoints nothing (neither package reads its remat)
    code_passes = 4 if cfg.remat and not hasattr(cfg, "width_mult") else 3
    bound = vision_bound(work, train_bytes(report["params"], 2), peaks, 3,
                         code_passes)
    return {"argv": argv, "params": report["params"], "init_s": init_s,
            "batch": batch, "device_ms_per_step": 1e3 * med,
            "device_ms_per_step_all": [1e3 * w for w in walls],
            "images_per_s": batch / med, "code_passes": code_passes,
            "bound_ms_per_step": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "bound_share": bound["bound_ms"] / (1e3 * med),
            "tflop": bound["tflop"], "code_tflop": bound["code_tflop"],
            "code_extra_ms_at_peak": bound["code_extra_ms_at_peak"],
            "peak_memory_gb": peak / 1e9,
            "losses": [(h["step"], h["loss"]) for h in hist],
            "launches": launches}


def _images(batch, res, seed, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(batch, res, res, 3, generator=g, device=dev)


def forward_entry(fn, peaks, work, nbytes, batch, out_check, iters):
    """A forward timed with CUDA events (``iters`` calls after 2 warm-up
    calls, no gradients), its output checked, against its bound
    (``vision_bound``); the achieved rate counts the function's work."""
    import torch
    with torch.no_grad():
        out = fn()
        out_check(out)
        del out
        ms = time_ms(fn, iters=iters, warmup=2)
    bound = vision_bound(work, nbytes, peaks)
    return {"batch": batch, "ms": ms, "images_per_s": 1e3 * batch / ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "tflop": bound["tflop"], "code_tflop": bound["code_tflop"],
            "achieved_tflop_per_s": bound["tflop"] / (ms / 1e3),
            "bound_share": bound["bound_ms"] / ms,
            "code_extra_ms_at_peak": bound["code_extra_ms_at_peak"]}


def _finite(t, shape, what):
    import torch
    check(tuple(t.shape) == tuple(shape) and t.dtype == torch.float32
          and bool(torch.isfinite(t).all()),
          f"{what}: {tuple(t.shape)} {t.dtype} finite="
          f"{bool(torch.isfinite(t).all())}")


def built_train_entry(ops, peaks, spec, step, n_params, work, passes):
    """``STEPS_VISION_STEPS`` calls of ``step`` (one step of the built
    train ``spec`` on the model's weights, in place), each between two
    synchronisations of the card: ms/step (median of steps 2 to N), the
    loss finite at every step, peak GB, no kernel launched, and the
    bound as ``train_entry`` counts it (3 passes of the function's
    ``work``; ``passes``, the code's, beside it)."""
    import math
    import statistics
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(ops.LAUNCHES)
    walls, losses = [], []
    for _ in range(STEPS_VISION_STEPS):
        loss, w = _synced(step)
        walls.append(w)
        losses.append(float(loss))
    launches = _launches_since(ops, before)
    check(sum(launches.values()) == 0 and all(map(math.isfinite, losses)),
          f"{spec.name}: launches {launches}, losses {losses}")
    med = statistics.median(walls[1:])
    bound = vision_bound(work, train_bytes(n_params, 2), peaks, 3, passes)
    return {"cell": spec.name, "ms_per_step": 1e3 * med,
            "ms_per_step_all": [1e3 * w for w in walls],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": losses, "code_passes": passes,
            "bound_ms_per_step": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "bound_share": bound["bound_ms"] / (1e3 * med),
            "code_extra_ms_at_peak": bound["code_extra_ms_at_peak"]}


def vision_path(ops, peaks):
    """The vision and diffusion models at full width in their configs'
    bf16, on the card, served and trained through the built steps of
    ``repro_torch.launch.steps`` (each cell's cut printed): vit-l16 (init;
    the serve step at serve_b128 and at cls_384's shape as a serve cell,
    with the pos table resized 14 -> 24, and ``features_only``; a built
    cls_224 train step at batch ``STEPS_VISION_BATCH``; then
    ``launch.train --arch vit-l16 --full`` at batch ``VIT_TRAIN_BATCH``
    with remat), deit-b (the serve step at batch ``DEIT_BATCH``), dit-b2
    (the gen_fast serve step, the DDIM ``sample``: 512 px -> 64 x 64 x 4
    latents, 1024 tokens, 16 latents, 4 steps; a built train_256 step at
    a small batch; then ``launch.train --arch dit-b2 --full`` at 256 px)
    and efficientnet-b7 (the serve step at 600 px, batch ``EFF_BATCH``;
    a built cls_224 train step at a small batch; then ``launch.train
    --arch efficientnet-b7 --full``). Each line: images/s (ms per
    sampler step for DiT), ms per training step, peak GB, and the bound
    from the function's operations and bytes (``vision_bound``: every
    product on the bf16 tensor cores, 3 passes a training step), with the
    code's extra work (q.k^T in fp32, remat's recompute) beside it. None
    of the six kernels launches (the JAX package's models attend with
    ``causal=False``, and its flash route is causal only,
    ``models/layers.py:161``)."""
    import torch
    from repro_torch.common.config import DIT_SHAPES, VISION_SHAPES
    from repro_torch.common.device import resolve_device
    from repro_torch.launch import steps
    from repro_torch.models import dit as D
    from repro_torch.models import efficientnet as E
    from repro_torch.models import vit as V
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import param_leaves

    dev = resolve_device("cuda")
    ops.reset_launches()
    out = {}

    def labels(B, n):
        return torch.arange(B, device=dev, dtype=torch.int32) % n

    # vit-l16: the Focus GT-CNN
    cfg = vision_config("vit-l16")
    serve, cut384 = VISION_SHAPES["serve_b128"], _cut(
        VISION_SHAPES["cls_384"], kind="serve")
    cls384 = cut384[0]
    serve_step = steps.build_vit(cfg, serve).fn
    serve384 = steps.build_vit(cfg, cls384).fn
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = V.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    wbytes = tree_bytes(params)
    n_params = sum(x.numel() for x in _flat_tree(params))
    # the config's count leaves out the CLS token's D values
    check(n_params == cfg.n_params() + cfg.d_model,
          f"vit-l16 has {n_params} parameters")
    x = _images(serve.global_batch, serve.img_res, 0, dev)
    nbytes = wbytes + x.numel() * 4 + serve.global_batch * cfg.n_classes * 4
    v = {"params": n_params, "init_s": init_s,
         "tokens": cfg.n_tokens(serve.img_res)}
    v["serve_b128"] = forward_entry(
        lambda: serve_step(params, x), peaks,
        partial(vit_work, cfg, serve.global_batch, serve.img_res), nbytes,
        serve.global_batch,
        lambda o: _finite(o, (serve.global_batch, cfg.n_classes),
                          "vit-l16 logits"), VISION_ITERS)
    v["features_only"] = forward_entry(
        lambda: V.forward(params, x, cfg, features_only=True), peaks,
        partial(vit_work, cfg, serve.global_batch, serve.img_res), nbytes,
        serve.global_batch,
        lambda o: _finite(o, (serve.global_batch, cfg.d_model),
                          "vit-l16 features"), VISION_ITERS)
    del x
    x = _images(cls384.global_batch, cls384.img_res, 1, dev)
    v["cls_384"] = dict(forward_entry(
        lambda: serve384(params, x), peaks,
        partial(vit_work, cfg, cls384.global_batch, cls384.img_res),
        wbytes + x.numel() * 4, cls384.global_batch,
        lambda o: _finite(o, (cls384.global_batch, cfg.n_classes),
                          "vit-l16 logits at 384"), VISION_ITERS),
        cut=cut384[1], tokens=cfg.n_tokens(cls384.img_res),
        pos_grid=[cfg.img_res // cfg.patch, cls384.img_res // cfg.patch])
    v["forward_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    step_s = v["serve_b128"]["ms"] / 1e3
    with torch.no_grad():
        x = _images(serve.global_batch, serve.img_res, 0, dev)
        v["serve_b128_profile"] = step_profile(
            lambda: serve_step(params, x), step_s)
    del x
    cell, cut = _cut(VISION_SHAPES["cls_224"], global_batch=STEPS_VISION_BATCH)
    spec = steps.build_vit(cfg, cell)
    state = opt.init(param_leaves(params))
    batch = {"images": _images(cell.global_batch, cell.img_res, 4, dev),
             "labels": labels(cell.global_batch, cfg.n_classes)}
    v["built_train"] = dict(built_train_entry(
        ops, peaks, spec, lambda: spec.fn(params, state, batch)[-1],
        n_params, partial(vit_work, cfg, cell.global_batch, cell.img_res),
        4 if cfg.remat else 3), cut=cut)
    del params, state, batch
    torch.cuda.empty_cache()
    v["train"] = train_entry(
        ops, peaks, "vit-l16", VIT_TRAIN_BATCH, VISION_TRAIN_STEPS,
        (V, "init"), partial(vit_work, cfg, VIT_TRAIN_BATCH, cfg.img_res))
    out["vit-l16"] = v

    # deit-b: the distillation token and its second head
    cfg = vision_config("deit-b")
    serve_step = steps.build_vit(cfg, serve).fn
    torch.cuda.reset_peak_memory_stats()
    params = V.init(cfg, seed=0, device="cuda")
    x = _images(DEIT_BATCH, cfg.img_res, 2, dev)
    out["deit-b"] = {
        "params": sum(t.numel() for t in _flat_tree(params)),
        "tokens": cfg.n_tokens(),
        "serve": forward_entry(
            lambda: serve_step(params, x), peaks,
            partial(vit_work, cfg, DEIT_BATCH, cfg.img_res),
            tree_bytes(params) + x.numel() * 4, DEIT_BATCH,
            lambda o: _finite(o, (DEIT_BATCH, cfg.n_classes),
                              "deit-b logits"), VISION_ITERS),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, x
    torch.cuda.empty_cache()

    # dit-b2: the DDIM sampler at gen_fast, then training at 256 px
    cfg = vision_config("dit-b2")
    gen = DIT_SHAPES["gen_fast"]
    sample = steps.build_dit(cfg, gen).fn
    torch.cuda.reset_peak_memory_stats()
    params = D.init(cfg, seed=0, device="cuda")
    ys = labels(gen.global_batch, cfg.n_classes)
    seed = torch.zeros(2, dtype=torch.uint32)        # key(0)
    res = gen.img_res // cfg.vae_factor
    with torch.no_grad():
        lat = sample(params, ys, seed)
        _finite(lat, (gen.global_batch, res, res, cfg.latent_channels),
                "dit-b2 sample")
        sample_ms = time_ms(lambda: sample(params, ys, seed),
                            iters=VISION_ITERS // 2, warmup=1)
    work = partial(dit_work, cfg, gen.global_batch, gen.img_res)
    bound = vision_bound(work, tree_bytes(params) * gen.steps
                         + 2 * lat.numel() * 4, peaks, gen.steps)
    out["dit-b2"] = {
        "params": sum(t.numel() for t in _flat_tree(params)),
        "gen_fast": {"img_res": gen.img_res, "batch": gen.global_batch,
                     "steps": gen.steps, "tokens": cfg.n_tokens(gen.img_res),
                     "timesteps": D.ddim_timesteps(gen.steps),
                     "sample_ms": sample_ms,
                     "ms_per_step": sample_ms / gen.steps,
                     "images_per_s": 1e3 * gen.global_batch / sample_ms,
                     "bound_ms": bound["bound_ms"],
                     "bound_ms_per_step": bound["bound_ms"] / gen.steps,
                     "bound_by": bound["bound_by"],
                     "bound_share": bound["bound_ms"] / sample_ms,
                     "code_extra_ms_at_peak": bound["code_extra_ms_at_peak"],
                     "pos_grid": [int(cfg.n_tokens() ** 0.5),
                                  int(cfg.n_tokens(gen.img_res) ** 0.5)]},
        "sample_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del lat
    cell, cut = _cut(DIT_SHAPES["train_256"], global_batch=STEPS_VISION_BATCH)
    spec = steps.build_dit(cfg, cell)
    state = opt.init(param_leaves(params))
    res = cell.img_res // cfg.vae_factor
    g = torch.Generator(device=dev).manual_seed(5)
    batch = {"latents": torch.randn(cell.global_batch, res, res,
                                    cfg.latent_channels, generator=g,
                                    device=dev),
             "labels": labels(cell.global_batch, cfg.n_classes)}
    out["dit-b2"]["built_train"] = dict(built_train_entry(
        ops, peaks, spec, lambda: spec.fn(params, state, batch, seed)[-1],
        out["dit-b2"]["params"],
        partial(dit_work, cfg, cell.global_batch, cell.img_res),
        4 if cfg.remat else 3), cut=cut)
    del params, state, batch
    torch.cuda.empty_cache()
    out["dit-b2"]["train"] = train_entry(
        ops, peaks, "dit-b2", DIT_TRAIN_BATCH, VISION_TRAIN_STEPS,
        (D, "init"), partial(dit_work, cfg, DIT_TRAIN_BATCH, cfg.img_res))

    # efficientnet-b7 at its native 600 px: eval forward, then training
    cfg = vision_config("efficientnet-b7")
    cell600, cut600 = _cut(serve, img_res=cfg.img_res, global_batch=EFF_BATCH)
    serve_step = steps.build_effnet(cfg, cell600).fn
    torch.cuda.reset_peak_memory_stats()
    params, bn = E.init(cfg, seed=0, device="cuda")
    x = _images(EFF_BATCH, cfg.img_res, 3, dev)
    e = {"params": sum(t.numel() for t in _flat_tree(params)),
         "blocks": len(E.block_specs(cfg)),
         "gflop_per_image": E.flops_per_image(cfg) / 1e9}
    e["eval"] = dict(forward_entry(
        lambda: serve_step(params, bn, x), peaks,
        partial(effnet_work, cfg, EFF_BATCH, cfg.img_res),
        tree_bytes(params) + x.numel() * 4, EFF_BATCH,
        lambda o: _finite(o, (EFF_BATCH, cfg.n_classes),
                          "efficientnet-b7 logits"), VISION_ITERS),
        cut=cut600)
    e["eval_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        e["eval_profile"] = step_profile(
            lambda: serve_step(params, bn, x), e["eval"]["ms"] / 1e3)
    del x
    cell, cut = _cut(VISION_SHAPES["cls_224"], global_batch=STEPS_VISION_BATCH)
    spec = steps.build_effnet(cfg, cell)
    state = opt.init(param_leaves(params))
    batch = {"images": _images(cell.global_batch, cell.img_res, 6, dev),
             "labels": labels(cell.global_batch, cfg.n_classes)}
    held = {"bn": bn}

    def effnet_step():
        _, held["bn"], _, loss = spec.fn(params, held["bn"], state, batch)
        return loss
    # EfficientNet checkpoints nothing (neither package reads its remat)
    e["built_train"] = dict(built_train_entry(
        ops, peaks, spec, effnet_step, e["params"],
        partial(effnet_work, cfg, cell.global_batch, cell.img_res), 3),
        cut=cut)
    del params, bn, state, batch, held
    torch.cuda.empty_cache()
    e["train"] = train_entry(
        ops, peaks, "efficientnet-b7", EFF_TRAIN_BATCH, EFF_TRAIN_STEPS,
        (E, "init"), partial(effnet_work, cfg, EFF_TRAIN_BATCH, cfg.img_res))
    out["efficientnet-b7"] = e
    launches = dict(ops.LAUNCHES)
    check(sum(launches.values()) == 0,
          f"the vision path launched a kernel: {launches}")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 3: the multi-card layer on a one-rank mesh
# ---------------------------------------------------------------------------

def _mesh_train(spec, params, batches, mesh=None):
    """The built train step ``spec`` from a copy of ``params``, one step
    per batch, each between two synchronisations (on ``mesh`` the state
    laid out by ``spec.in_shardings`` first): (losses, the steps' s, the
    parameters and AdamW's moments gathered whole)."""
    from repro_torch.distributed.sharding import distribute, full_tensor
    from repro_torch.models.layers import tree_map
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import param_leaves
    p = tree_map(lambda t: t.clone(), params)
    state = opt.init(param_leaves(p))
    if mesh is not None:
        p, state = (distribute(x, s, mesh) for x, s in
                    zip((p, state), spec.in_shardings[:2]))
    losses, walls = [], []
    for b in batches:
        (p, state, loss), w = _synced(lambda: spec.fn(p, state, b))
        losses.append(float(full_tensor(loss)))
        walls.append(w)
    final = full_tensor(param_leaves(p))
    m, v = full_tensor(state["m"]), full_tensor(state["v"])
    del p, state
    return losses, walls, final, m, v


def _largest_diff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b)) if a else 0.0


def mesh_path(ops, peaks):
    """The multi-card layer on the card: a one-rank NCCL group and
    ``launch.mesh.make_mesh((1, 1), ("data", "model"))``, the port's
    ``DeviceMesh`` and DTensor layout of the JAX package's (pod, data,
    model) sharding (one card shows a one-rank mesh; ``tests/
    test_torch_mesh.py`` holds the multi-rank semantics on 4 gloo ranks).
    The launch counters are zeroed before and read after; on it:

    - olmo-1b at full width with ``MESH_LAYERS`` layers, its built
      train_4k step (batch cut to ``STEPS_TRAIN_BATCH`` x 4096)
      ``MESH_TRAIN_STEPS`` steps on the mesh and unsharded from the same
      weights and batches: the loss lines, AdamW's moments and each
      parameter's change bitwise equal (else the largest difference is
      reported and held to 1e-6 of each leaf's largest |change|);
      ms/step both ways and peak GB;
    - its built prefill_32k step (batch ``STEPS_PREFILL_BATCH``), two
      calls each way (the first ones warm up): ``flash_attention``
      through ``local_map``, once per layer a call, the logits bitwise
      the unsharded step's;
    - moonshot-v1-16b-a3b at full width with ``MESH_LAYERS`` layers, its
      experts on ``"model"``: a built prefill of ``MESH_MOE_BATCH`` x
      ``MESH_MOE_SEQ`` tokens, ``topk`` and ``flash_attention`` once per
      layer a call, routing (choices, slots, capacity cut) and logits
      equal to the unsharded call's; its built train_4k step (batch
      ``STEPS_MOE_BATCH``, the config's micro-batches and remat), one
      step on the mesh and unsharded from the same weights and batch,
      the experts' weights gathered over "data" before their products
      (ROADMAP C26): loss, AdamW's moments and the parameters bitwise
      equal, ``topk`` once per layer, micro-batch and recompute;
    - ``compressed_psum`` over ``"data"`` on a ``MESH_PSUM_SHAPE`` fp32
      tensor: bitwise the int8 round trip at its own scale; timed;
    - the trained olmo-1b state saved from the mesh, restored onto it
      with ``param_shardings`` and ``reshard`` onto ``choose_mesh()``:
      every leaf bitwise equal, on its stated placement;
    - ``sharding.CONSTRAIN_MISSES`` 0.

    The group is destroyed at the end, also when a check fails."""
    import torch
    import torch.distributed as dist
    from repro_torch.common.config import LM_SHAPES
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train import compression, elastic
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_loop import param_leaves

    t_path = time.perf_counter()
    # device memory the earlier phases left: what only a reference cycle
    # keeps stays allocated until the collector runs, and this path needs
    # most of the card
    held = [torch.cuda.memory_allocated() / 1e9
            if MESH_DEVICE == "cuda" else 0.0]
    gc.collect()
    torch.cuda.empty_cache()
    held.append(torch.cuda.memory_allocated() / 1e9
                if MESH_DEVICE == "cuda" else 0.0)
    ops.reset_launches()
    S.CONSTRAIN_MISSES = 0
    mesh = make_mesh((1, 1), ("data", "model"), device=MESH_DEVICE)
    out = {"backend": dist.get_backend(), "mesh": list(mesh.shape),
           "mesh_axes": list(mesh.mesh_dim_names),
           "allocated_gb_at_start": {"before_gc": held[0],
                                     "after_gc": held[1]}}
    if MESH_DEVICE == "cuda":
        out["nccl_version"] = ".".join(map(str, torch.cuda.nccl.version()))
        check(out["backend"] == "nccl", f"mesh backend {out['backend']}")
    dev = torch.device(MESH_DEVICE)
    try:
        # olmo-1b's train step, on the mesh and unsharded
        cfg = lm_config(n_layers=MESH_LAYERS)
        cut = {"n_layers": [lm_config().n_layers, MESH_LAYERS]}
        params = T.init(cfg, seed=0, device=dev)
        cell, bcut = _cut(LM_SHAPES["train_4k"],
                          global_batch=STEPS_TRAIN_BATCH)
        B, L = cell.global_batch, cell.seq_len
        batches = []
        for i in range(MESH_TRAIN_STEPS):
            toks = _lm_tokens(cfg, B, L + 1, 200 + i, dev)
            batches.append({"tokens": toks[:, :-1].contiguous(),
                            "labels": toks[:, 1:].contiguous()})
        before = [t.clone() for t in param_leaves(params)]
        torch.cuda.reset_peak_memory_stats()
        plain = _mesh_train(steps.build_lm(cfg, cell), params, batches)
        plain_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        spec = steps.build_lm(cfg, cell, mesh)
        sharded = _mesh_train(spec, params, batches, mesh)
        mesh_peak = torch.cuda.max_memory_allocated() / 1e9
        change = lambda fin: [a.float() - b.float()
                              for a, b in zip(fin, before)]
        ch_p, ch_m = change(plain[2]), change(sharded[2])
        bitwise = (plain[0] == sharded[0] and all(
            torch.equal(a, b) for a, b in
            zip(plain[2] + plain[3] + plain[4],
                sharded[2] + sharded[3] + sharded[4])))
        worst = max(float((a - b).abs().max()
                          / max(float(b.abs().max()), 1e-30))
                    for a, b in zip(ch_m, ch_p))
        check(bitwise or (worst <= 1e-6 and _largest_diff(
            plain[3] + plain[4], sharded[3] + sharded[4]) <= 1e-6 * max(
                float(x.abs().max()) for x in plain[3] + plain[4])),
              f"olmo-1b train_4k on the mesh against unsharded: losses "
              f"{sharded[0]} / {plain[0]}, worst change {worst}")
        out["train"] = {
            "cell": spec.name, "cut": dict(cut, **bcut),
            "in_shardings_example": {
                "tok_embed": list(spec.in_shardings[0]["tok_embed"]),
                "layers/attn/wq": list(
                    spec.in_shardings[0]["layers"]["attn"]["wq"])},
            "batch": B, "seq": L, "steps": MESH_TRAIN_STEPS,
            "losses_mesh": sharded[0], "losses_unsharded": plain[0],
            "bitwise_equal": bitwise,
            "max_change_diff_over_largest_change": worst,
            "max_moment_diff": _largest_diff(plain[3] + plain[4],
                                             sharded[3] + sharded[4]),
            "ms_per_step_mesh": [1e3 * w for w in sharded[1]],
            "ms_per_step_unsharded": [1e3 * w for w in plain[1]],
            "peak_memory_gb_mesh": mesh_peak,
            "peak_memory_gb_unsharded": plain_peak}
        trained = (sharded[2], sharded[3], sharded[4])
        del plain, sharded, ch_p, ch_m, before, batches
        torch.cuda.empty_cache()

        # olmo-1b's built prefill: flash_attention under DTensor
        cell, pcut = _cut(LM_SHAPES["prefill_32k"],
                          global_batch=STEPS_PREFILL_BATCH)
        tokens = _lm_tokens(cfg, cell.global_batch, cell.seq_len, 210, dev)
        plain_fn = steps.build_lm(cfg, cell).fn
        spec = steps.build_lm(cfg, cell, mesh)
        dparams = S.distribute(params, spec.in_shardings[0], mesh)
        plain_s, mesh_s = [], []
        for _ in range(2):          # the first calls include the warm-up
            want, w = _synced(lambda: plain_fn(params, tokens))
            plain_s.append(w)
            before = dict(ops.LAUNCHES)
            got, w = _synced(lambda: spec.fn(dparams, tokens))
            mesh_s.append(w)
            n = _launches_since(ops, before)
        got = got.full_tensor()
        check(n == {**{k: 0 for k in n}, "flash_attention": MESH_LAYERS},
              f"{spec.name} on the mesh launched {n}")
        check(torch.equal(got, want), f"{spec.name} on the mesh: logits "
              f"differ from unsharded by {_largest_diff([got], [want])}")
        out["prefill"] = {"cell": spec.name, "cut": dict(cut, **pcut),
                          "launches_per_call": n, "bitwise_equal": True,
                          "s_mesh_calls": mesh_s,
                          "s_unsharded_calls": plain_s}
        del got, want, tokens, dparams
        torch.cuda.empty_cache()

        # moonshot: the router's topk and flash_attention under DTensor
        arch = "moonshot-v1-16b-a3b"
        mcfg = lm_config(arch, n_layers=MESH_LAYERS)
        mparams = T.init(mcfg, seed=0, device=dev)
        cell, mcut = _cut(LM_SHAPES["prefill_32k"],
                          global_batch=MESH_MOE_BATCH, seq_len=MESH_MOE_SEQ)
        tokens = _lm_tokens(mcfg, cell.global_batch, cell.seq_len, 220, dev)
        plain_fn = steps.build_lm(mcfg, cell).fn
        spec = steps.build_lm(mcfg, cell, mesh)
        check(list(spec.in_shardings[0]["layers"]["moe"]["wi"])[1]
              == "model", "moonshot's experts are not on 'model'")
        dparams = S.distribute(mparams, spec.in_shardings[0], mesh)
        plain_s, mesh_s = [], []
        for _ in range(2):          # the first calls include the warm-up
            with recorded_routes() as r_plain:
                want, w = _synced(lambda: plain_fn(mparams, tokens))
            plain_s.append(w)
            before = dict(ops.LAUNCHES)
            with recorded_routes() as r_mesh:
                got, w = _synced(lambda: spec.fn(dparams, tokens))
            mesh_s.append(w)
            n = _launches_since(ops, before)
        got = got.full_tensor()
        check(n == {**{k: 0 for k in n}, "flash_attention": MESH_LAYERS,
                    "topk": MESH_LAYERS},
              f"{spec.name} on the mesh launched {n}")
        same_routes = len(r_plain) == len(r_mesh) == MESH_LAYERS and all(
            torch.equal(a, b) for x, y in zip(r_plain, r_mesh)
            for a, b in zip(x[1:], y[1:]))
        check(same_routes, f"{spec.name}: the mesh routes otherwise")
        check(torch.equal(got, want), f"{spec.name} on the mesh: logits "
              f"differ from unsharded by {_largest_diff([got], [want])}")
        out["moe_prefill"] = {
            "cell": spec.name,
            "cut": dict(mcut, n_layers=[lm_config(arch).n_layers,
                                        MESH_LAYERS]),
            "experts_spec": list(spec.in_shardings[0]["layers"]["moe"]
                                 ["wi"]),
            "launches_per_call": n, "routes_equal": True,
            "logits_bitwise_equal": True, "s_mesh_calls": mesh_s,
            "s_unsharded_calls": plain_s}
        del dparams, got, want, tokens, r_plain, r_mesh
        torch.cuda.empty_cache()

        # moonshot's train step: the experts' FSDP weights gathered
        # before their products (ROADMAP C26), the router under DTensor
        cell, tcut = _cut(LM_SHAPES["train_4k"],
                          global_batch=STEPS_MOE_BATCH)
        toks = _lm_tokens(mcfg, cell.global_batch, cell.seq_len + 1, 240,
                          dev)
        batches = [{"tokens": toks[:, :-1].contiguous(),
                    "labels": toks[:, 1:].contiguous()}]
        plain = _mesh_train(steps.build_lm(mcfg, cell), mparams, batches)
        # the unsharded parameters and moments wait on the host: beside the
        # sharded step's state and peak they would bring the card to its
        # 80 GB
        plain = plain[:2] + tuple([t.cpu() for t in x] for x in plain[2:])
        spec = steps.build_lm(mcfg, cell, mesh)
        before = dict(ops.LAUNCHES)
        sharded = _mesh_train(spec, mparams, batches, mesh)
        n = _launches_since(ops, before)
        per_step = MESH_LAYERS * mcfg.train_microbatches * (
            2 if mcfg.remat else 1)
        check(n == {**{k: 0 for k in n}, "topk": per_step},
              f"{spec.name} on the mesh launched {n}, expected {per_step} "
              f"topk")
        bitwise = (plain[0] == sharded[0] and all(
            torch.equal(a.to(b.device), b) for a, b in
            zip(plain[2] + plain[3] + plain[4],
                sharded[2] + sharded[3] + sharded[4])))
        check(bitwise, f"{spec.name} on the mesh against unsharded: losses "
              f"{sharded[0]} / {plain[0]}, largest parameter difference "
              f"{_largest_diff(plain[2], [t.cpu() for t in sharded[2]])}")
        out["moe_train"] = {
            "cell": spec.name,
            "cut": dict(tcut, n_layers=[lm_config(arch).n_layers,
                                        MESH_LAYERS]),
            "microbatches": mcfg.train_microbatches, "remat": mcfg.remat,
            "experts_spec": list(spec.in_shardings[0]["layers"]["moe"]
                                 ["wi"]),
            "launches_per_step": n, "bitwise_equal": True,
            "losses_mesh": sharded[0], "losses_unsharded": plain[0],
            "ms_per_step_mesh": [1e3 * w for w in sharded[1]],
            "ms_per_step_unsharded": [1e3 * w for w in plain[1]]}
        del mparams, plain, sharded, toks, batches
        torch.cuda.empty_cache()

        # compressed_psum over "data"
        g = torch.Generator(device=dev).manual_seed(230)
        x = torch.randn(MESH_PSUM_SHAPE, generator=g, device=dev)
        got = compression.compressed_psum(x, mesh, "data")
        q, scale = compression._quant_int8(x)
        check(torch.equal(got, q.float() * scale),
              "compressed_psum on one rank is not the int8 round trip")
        out["compressed_psum"] = {
            "shape": list(MESH_PSUM_SHAPE), "axis": "data",
            "bitwise_round_trip": True,
            "ms": time_ms(lambda: compression.compressed_psum(
                x, mesh, "data"), iters=20, warmup=3)}
        del x, got, q

        # save from the mesh, restore onto it, reshard onto choose_mesh()
        specs = S.param_shardings(params, mesh)
        p_mesh = S.distribute(params, specs, mesh)
        tree = {"params": p_mesh, "m": trained[1], "v": trained[2]}
        with tempfile.TemporaryDirectory() as d:
            ckpt = CheckpointManager(d, async_save=False)
            (_, save_s) = _synced(lambda: ckpt.save(1, tree))
            ckpt.wait()
            (_, back, _), load_s = _synced(lambda: ckpt.restore(
                device=dev, shardings={"params": specs, "m": None,
                                       "v": None}, mesh=mesh))
        ok = all(torch.equal(a.full_tensor(), b) and tuple(a.placements)
                 == S.to_placements(s, mesh)
                 for (_, a), (_, b), (_, s) in zip(
                     S.tree_paths(back["params"]), S.tree_paths(params),
                     S.tree_paths(specs)))
        ok &= all(torch.equal(a, b) for a, b in
                  zip(back["m"] + back["v"], trained[1] + trained[2]))
        check(ok, "the restored state differs from the saved one")
        new_mesh = elastic.choose_mesh()
        moved = elastic.reshard(back["params"], new_mesh)
        new_specs = S.param_shardings(params, new_mesh)
        ok = all(torch.equal(a.full_tensor(), b) and tuple(a.placements)
                 == S.to_placements(s, new_mesh)
                 for (_, a), (_, b), (_, s) in zip(
                     S.tree_paths(moved), S.tree_paths(params),
                     S.tree_paths(new_specs)))
        check(ok, "reshard onto choose_mesh() changed a leaf")
        out["checkpoint"] = {"leaves": len(S.full_tensor(
            param_leaves(params))) * 3, "save_s": save_s, "load_s": load_s,
            "restored_bitwise": True,
            "reshard_mesh": list(new_mesh.shape),
            "reshard_axes": list(new_mesh.mesh_dim_names),
            "resharded_bitwise": True}
        del params, p_mesh, tree, back, moved, trained
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    launches = dict(ops.LAUNCHES)
    check(launches["flash_attention"] > 0 and launches["topk"] > 0,
          f"the mesh path's kernels never launched: {launches}")
    check(S.CONSTRAIN_MISSES == 0,
          f"{S.CONSTRAIN_MISSES} constrain calls missed the mesh")
    out.update(launches=launches, constrain_misses=S.CONSTRAIN_MISSES,
               path_s=time.perf_counter() - t_path)
    return out


# ---------------------------------------------------------------------------
# phase 3: the gate tune and the dry run (repro_torch.launch.hillclimb,
# repro_torch.launch.dryrun)
# ---------------------------------------------------------------------------

GATE_LONG_FRAMES = 3600
# the dry run's cells on the card's torch: (arch, cells), each on both
# production meshes
DRYRUN_CELLS = (("olmo-1b", "train_4k,prefill_32k"),
                ("moonshot-v1-16b-a3b", "prefill_32k,train_4k"),
                ("dbrx-132b", "train_4k"),
                ("vit-l16", "cls_224"))
# the MoE train cells whose wire bytes by model line are printed: the
# experts' weights gathered over the data axes before their products
# (ROADMAP C26), which move nothing, and their output moved by the
# experts' all-to-all (C24), as this machine's torch plans them
DRYRUN_WIRE_CELLS = (("moonshot-v1-16b-a3b", "train_4k"),
                     ("dbrx-132b", "train_4k"))
DRYRUN_TIMEOUT_S = 240


def gate_tune_path(ops, ref):
    """``hillclimb.gate_tune`` on the card at the JAX package's defaults,
    its record equal to the CPU run's in this process; the launch
    counters zeroed before the card's run and read after (``pixel_match``
    from the gate and the tracker, ``centroid_assign`` from the
    clustering, each > 0). Then again at ``GATE_LONG_FRAMES`` frames: the
    redundancy gate's host-inclusive ms per frame (its ``match`` calls,
    each synchronised by the match indices' read-back), its ring's upload
    bytes per ``match_flat`` call, and the gate's own ``pixel_match``
    launches. That run keeps the inputs of the gate's ``match_flat`` call
    with the largest ring and of the clustering's last
    ``centroid_assign`` call, and ``gate_kernels_check`` holds both
    kernels on them against their plain versions."""
    import torch
    from repro_torch.core import streaming as S
    from repro_torch.launch import hillclimb
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    cpu = hillclimb.gate_tune(device="cpu")
    cpu_s = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    card = hillclimb.gate_tune(device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(card == cpu, "the card's gate_tune record differs from the CPU's")
    check(launches["pixel_match"] > 0 and launches["centroid_assign"] > 0,
          f"gate_tune's kernels never launched: {launches}")

    gate = {"match_s": 0.0, "calls": 0, "ring_bytes": [], "launches": 0}
    # the inputs of the gate's call with the largest ring and of the
    # clustering's last call, kept by reference (each call makes its own)
    seen = {}
    real_match, real_flat = S._RedundancyGate.match, S.match_flat
    real_stacked = ops.centroid_assign_stacked

    def timed_match(self, f, crops2d):
        t = time.perf_counter()
        out = real_match(self, f, crops2d)
        gate["match_s"] += time.perf_counter() - t
        gate["calls"] += 1
        return out

    def counted_flat(a, b, threshold, device="cuda"):
        before = ops.LAUNCHES["pixel_match"]
        out = real_flat(a, b, threshold, device=device)
        gate["launches"] += ops.LAUNCHES["pixel_match"] - before
        gate["ring_bytes"].append(int(b.nbytes))
        if "gate" not in seen or len(b) > len(seen["gate"][1]):
            seen["gate"] = (a, b, threshold)
        return out

    def kept_stacked(feats, centroids, threshold=None):
        seen["assign"] = (feats, centroids, threshold)
        return real_stacked(feats, centroids, threshold=threshold)

    S._RedundancyGate.match, S.match_flat = timed_match, counted_flat
    ops.centroid_assign_stacked = kept_stacked
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        long = hillclimb.gate_tune(n_frames=GATE_LONG_FRAMES, device="cuda")
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t0
    finally:
        S._RedundancyGate.match, S.match_flat = real_match, real_flat
        ops.centroid_assign_stacked = real_stacked
    long_launches = dict(ops.LAUNCHES)
    check(gate["launches"] > 0, "the gate never launched pixel_match")
    kernels = gate_kernels_check(ops, ref, seen)
    ring = gate["ring_bytes"]
    return {
        "record_equal_cpu": True, "record": card, "launches": launches,
        "kernels_on_path_inputs": kernels, "cpu_s": cpu_s, "card_s": card_s,
        "long": {"n_frames": GATE_LONG_FRAMES, "wall_s": long_s,
                 "n_objects": long["n_objects"],
                 "final_stride": long["final_stride"],
                 "launches": long_launches,
                 "gate_match_calls": gate["calls"],
                 "gate_match_s": gate["match_s"],
                 "gate_ms_per_frame": 1e3 * gate["match_s"]
                 / GATE_LONG_FRAMES,
                 "gate_pixel_match_launches": gate["launches"],
                 "ring_upload_calls": len(ring),
                 "ring_upload_bytes_per_call_mean": sum(ring) / len(ring),
                 "ring_upload_bytes_per_call_max": max(ring)},
        "path_s": time.perf_counter() - t_path}


def gate_kernels_check(ops, ref, seen):
    """``pixel_match`` and ``centroid_assign`` on the inputs that
    ``gate_tune_path``'s card run gave them, against their plain
    versions, as ``_match_pair`` and ``_assign_pair`` hold them (indices
    exact; distances within rtol 1e-6, and 1e-5 / 1e-4 for squared L2):
    the gate's crops against its ring as they came, and crops planted next
    to the threshold. A planted crop is ring row k moved by c in every
    element, toward the middle of [0, 1], so that its least mean |a - b|
    is c = threshold * (1 + eps); duplicates in the ring make it a tie to
    the lowest index. Likewise the clustering's features against its
    table as they came (one slot, dead rows at 1e9), through the stacked
    launch the path makes and a solo one, and features at distance
    T * (1 + eps) from live centroids. eps runs over -1e-2 .. 1e-2: the
    minima lie within 1% of the threshold, on both sides of it."""
    import numpy as np
    import torch
    check("gate" in seen and "assign" in seen,
          f"the card's gate_tune made no call to keep: {sorted(seen)}")
    r = np.random.default_rng(25)
    eps = np.array([-1e-2, -1e-3, -1e-4, 1e-4, 1e-3, 1e-2])
    dev = seen["assign"][0].device

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    a, b, thr = seen["gate"]
    err_pm = _match_pair(ops, ref, t(a), t(b), thr)[0]
    k = r.choice(len(b), len(eps), replace=False)
    near = b[k] + (np.where(b[k] > 0.5, -1.0, 1.0)
                   * (thr * (1 + eps))[:, None]).astype(np.float32)
    err, m = _match_pair(ops, ref, t(near), t(b), thr)
    d = ref.pixel_match_ref(t(near), t(b), thr)[1].cpu().numpy()
    check((np.abs(d / thr - 1 - eps) < 1e-4).all(),
          f"planted gate minima not at the threshold: {d / thr}")
    check(((m >= 0) == (eps < 0)).all(),
          f"pixel_match near the threshold: {m} for eps {eps}")
    err_pm = max(err_pm, err)

    f, c, T = seen["assign"]
    live = c[0, :, 0] < 1e8
    check(live.any(), "the kept centroid table has no live row")
    got = ops.centroid_assign_stacked(f, c, threshold=T)
    want = ref.centroid_assign_stacked_ref(f, c, T)
    check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
          "centroid_assign_stacked differs from its plain version on the "
          "path's inputs")
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    err_ca = _assign_pair(ops, ref, f[0], c[0], T)[0]
    rows = torch.nonzero(live).flatten().cpu().numpy()
    k = r.choice(rows, len(eps), replace=len(rows) < len(eps))
    v = r.normal(size=(len(eps), c.shape[2]))
    v *= (T * (1 + eps) / np.linalg.norm(v, axis=1))[:, None]
    fn = c[0].cpu().numpy()[k] + v.astype(np.float32)
    err, j, m = _assign_pair(ops, ref, t(fn), c[0], T)
    d2 = ref.centroid_assign_ref(t(fn), c[0], T)[0].cpu().numpy()
    check((np.abs(np.sqrt(d2) / T - 1 - eps) < 1e-3).all(),
          f"planted assign minima not at the threshold: {np.sqrt(d2) / T}")
    check((m == (eps < 0)).all(),
          f"centroid_assign near the threshold: {m} for eps {eps}")
    return {"pixel_match": {"ring": list(b.shape), "crops": len(a),
                            "threshold": thr, "max_abs_err": err_pm},
            "centroid_assign": {"feats": list(f.shape),
                                "centroids": list(c.shape),
                                "live": int(live.sum()), "threshold": T,
                                "max_abs_err": max(err_ca, err)}}


def dryrun_start(out_dir):
    """The dry run of ``DRYRUN_CELLS`` on both production meshes, started
    now in subprocesses on this machine's torch (a fake process group is
    global state of a process) and read by ``dryrun_finish``: each
    model's cells on the 512-rank mesh in a process of their own (its
    DTensor planning takes several times the 256-rank mesh's), and every
    cell on the 256-rank mesh in one more."""
    code = ("import json, sys\n"
            "from repro_torch.launch.dryrun import main\n"
            "rcs = [main(a) for a in json.loads(sys.argv[1])]\n"
            "sys.exit(max(rcs))\n")

    def argv(arch, cells, mesh):
        return ["--arch", arch, "--shape", cells, "--mesh", mesh, "--out",
                out_dir]

    jobs = [[argv(a, c, "multi")] for a, c in DRYRUN_CELLS]
    jobs.append([argv(a, c, "single") for a, c in DRYRUN_CELLS])
    env = dict(os.environ, PYTHONPATH=SRC)
    return [subprocess.Popen([sys.executable, "-c", code, json.dumps(j)],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for j in jobs]


def dryrun_stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def dryrun_finish(procs, out_dir, t_start):
    """Waits for the dry run, prints each record's summary line, and
    fails on any record that is not ``ok`` or traced no FLOP, and on a
    MoE cell that planned no all-to-all. For ``DRYRUN_WIRE_CELLS`` it
    prints the record's largest wire bytes by model line, the lines of
    ``layers.moe`` marked, and fails where one of them is at the expert
    products (ROADMAP C26)."""
    import inspect
    from repro_torch.launch.dryrun import summary
    from repro_torch.models import layers
    src, start = inspect.getsourcelines(layers.moe)

    def site(text):
        line = start + next(i for i, t in enumerate(src) if text in t)
        return f"models/layers.py:{line}"
    marks = {site("= (data_gathered(params[k])"): "experts' weights gathered",
             site("exp_out = constrain(exp_out"): "experts' output"}
    products = {site(t): "expert product" for t in (
        "h = torch.einsum(", "hg = torch.einsum(", "F.silu(hg) * h")}
    marks.update(products)
    try:
        deadline = time.perf_counter() + DRYRUN_TIMEOUT_S
        logs = [p.communicate(timeout=max(1.0, deadline
                                          - time.perf_counter()))[0]
                for p in procs]
    finally:
        dryrun_stop(procs)
    wall = time.perf_counter() - t_start
    for p, log in zip(procs, logs):
        check(p.returncode == 0,
              f"the dry run failed ({p.returncode}):\n{log[-3000:]}")
    recs = []
    for f in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, f)) as fh:
            rec = json.load(fh)
        tag = "multi" if "pod" in rec.get("mesh", {}) else "single"
        print(f"[dryrun] {rec['arch']} x {rec['cell']} x {tag}"
              f"{summary(rec)}", flush=True)
        check(rec.get("ok") and not rec.get("skipped"),
              f"dry run of {f}: {rec.get('error', rec.get('skip_reason'))}")
        check(rec["flops_per_device"] > 0, f"dry run of {f} traced no FLOP")
        if rec["arch"].startswith("moonshot"):
            check(rec["collectives"]["counts"]["all-to-all"] > 0,
                  f"dry run of {f} planned no all-to-all")
        if (rec["arch"], rec["cell"]) in DRYRUN_WIRE_CELLS:
            for w in rec["scanned_raw"]["wire_by_site"]:
                mark = f" <- {marks[w['site']]}" if w["site"] in marks \
                    else ""
                print(f"[dryrun] {rec['arch']} x {rec['cell']} x {tag} "
                      f"wire {w['site']} {w['kind']} k={w['group']} "
                      f"{w['wire_bytes'] / 1e9:.4f} GB{mark}", flush=True)
                check(w["site"] not in products,
                      f"dry run of {f}: {w['kind']} of {w['wire_bytes']} "
                      f"bytes at an expert product, {w['site']} (ROADMAP "
                      f"C26)")
        recs.append({
            "arch": rec["arch"], "cell": rec["cell"], "mesh": tag,
            "trace_s": rec["compile_s"],
            "flops_per_device": rec["flops_per_device"],
            "bytes_per_device": rec["bytes_per_device"],
            "live_gb_per_device": rec["memory"]["live_bytes_per_device"]
            / 1e9, "fits_80gb_hbm": rec["memory"]["fits_80gb_hbm"],
            "collective_counts": rec["collectives"]["counts"],
            "dominant": rec["roofline"]["dominant"],
            "bound_step_s": rec["roofline"]["bound_step_s"],
            "roofline_fraction": rec["roofline_fraction"]})
    check(len(recs) == 2 * sum(len(c.split(",")) for _, c in DRYRUN_CELLS),
          f"the dry run wrote {len(recs)} records")
    return {"records": recs, "wall_s": wall,
            "note": "modelled H100 cluster, traced on this host's CPU; no "
                    "kernel runs"}


# ---------------------------------------------------------------------------
# phase 4: card against CPU
# ---------------------------------------------------------------------------

def lm_logits_card_vs_cpu(cfg):
    """``cfg`` (fp32) with the same weights on both devices: the card's
    flash prefill of ``LM_CPU_BATCH`` x ``LM_CPU_SEQ`` tokens and 16
    decode steps against the CPU's (plain versions), within 1e-4 of the
    largest |logit|; for MoE, both runs' routes compared
    (``route_agreement``: the smallest top-k margin, the largest router
    difference, and identical choices wherever the margin exceeds it)."""
    import numpy as np
    import torch
    from repro_torch.common.device import resolve_device
    from repro_torch.models import transformer as T

    card = T.init(cfg, seed=1, device="cuda")
    cpu = T.tree_map(lambda x: x.cpu(), card)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (LM_CPU_BATCH, LM_CPU_SEQ))
    tp = torch.from_numpy(toks)
    tc = tp.to(resolve_device("cuda"))
    with recorded_routes() as ra:
        a = T.prefill(card, tc, cfg, attn_impl="flash").cpu()
    with recorded_routes() as rb:
        b = T.prefill(cpu, tp, cfg, attn_impl="flash")
    out = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": LM_CPU_BATCH, "seq": LM_CPU_SEQ,
           "prefill_rel": _rel_err(a, b)}
    if cfg.moe:
        out["prefill_routes"] = route_agreement(ra, rb, cfg.moe_top_k,
                                                "prefill card vs CPU")
    check(out["prefill_rel"] <= 1e-4, f"LM prefill card vs CPU: {out}")
    n = 16
    caches = [T.init_cache(cfg, LM_CPU_BATCH, n, device=d)
              for d in ("cuda", "cpu")]
    decode_rel, ra, rb = 0.0, [], []
    for t in range(n):
        with recorded_routes() as step_a:
            a, caches[0] = T.decode_step(card, caches[0], tc[:, t:t + 1], t,
                                         cfg)
        with recorded_routes() as step_b:
            b, caches[1] = T.decode_step(cpu, caches[1], tp[:, t:t + 1], t,
                                         cfg)
        ra += step_a
        rb += step_b
        decode_rel = max(decode_rel, _rel_err(a.cpu(), b))
    out.update(decode_steps=n, decode_rel=decode_rel)
    if cfg.moe:
        out["decode_routes"] = route_agreement(ra, rb, cfg.moe_top_k,
                                               "decode card vs CPU")
    check(decode_rel <= 1e-4, f"LM decode card vs CPU: {out}")
    del card, cpu, caches
    torch.cuda.empty_cache()
    return out


def lm_card_vs_cpu():
    """The LM at the path's width with ``LM_CPU_LAYERS`` layers, and
    moonshot-v1-16b-a3b at its full width with as many, both fp32
    (``lm_logits_card_vs_cpu``); and the threefry draws on the card
    against the CPU's: the cheap CNNs' ``init_params`` and the reduced
    LMs' ``init``, bit for bit."""
    import dataclasses
    import numpy as np
    from repro_torch.common.config import reduced
    from repro_torch.launch import zoo
    from repro_torch.models import cnn
    from repro_torch.models import transformer as T

    out = lm_logits_card_vs_cpu(
        lm_config(n_layers=LM_CPU_LAYERS, dtype="float32"))
    moe_arch = MOE_ARCHS[0][0]
    out["moe"] = {"arch": moe_arch, **lm_logits_card_vs_cpu(
        lm_config(moe_arch, n_layers=LM_CPU_LAYERS, dtype="float32"))}

    cnn_cfgs = [zoo.GENERIC_FAMILY["cheap1"][0]] + [
        dataclasses.replace(c, n_classes=7)
        for c, _ in zoo.SPECIALIZED_FAMILY.values()]
    for c in cnn_cfgs:
        a, b = (cnn.init_params(c, 0, device=d) for d in ("cuda", "cpu"))
        same = all(np.array_equal(x, y) for x, y in zip(_flat_tree(a),
                                                        _flat_tree(b)))
        check(same, f"{c.name}: the card's threefry draw differs from the "
              f"CPU's")
    smalls = [reduced(lm_config()), reduced(lm_config(moe_arch))]
    for small in smalls:
        a, b = (T.params_to_jax(T.init(small, 0, device=d))
                for d in ("cuda", "cpu"))
        check(all(np.array_equal(x, y) for x, y in zip(_flat_tree(a),
                                                       _flat_tree(b))),
              f"{small.name}: the draw differs between the card and the "
              f"CPU")
    out["init_draws_bitwise"] = [c.name for c in cnn_cfgs] + [
        c.name for c in smalls]
    return out


def train_card_vs_cpu_lm(cfg):
    """``cfg`` in fp32 (remat on; olmo-1b's width with ``LM_CPU_LAYERS``
    layers, and reduced moonshot-v1-16b-a3b, whose backward runs through
    the router's gather and the dispatch on the card), one init drawn on
    the card and copied to the CPU, the same batches of
    ``TRAIN_CPU_BATCH`` x ``TRAIN_CPU_SEQ`` tokens: the first step's
    gradients within 1e-5 of each leaf's largest |grad|, and
    ``TRAIN_CPU_STEPS`` steps of ``train`` on each device with losses
    within 1e-5 relative and parameters within 2 lr per step. Why that
    bound: over the first three steps of AdamW with b1 = 0.9 and b2 =
    0.95, |m^ / sqrt(v^)| <= 1.001 for any gradients (Cauchy-Schwarz over
    the moments' weights), so an element whose gradient is near zero and
    takes the other sign on one device moves by up to 2 lr per step;
    every other element agrees to fp32 rounding."""
    import numpy as np
    import torch
    from repro_torch.launch.train import lm_data
    from repro_torch.models import transformer as T
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.train_loop import param_leaves, train

    card = T.init(cfg, seed=0, device="cuda")
    cpu = T.tree_map(lambda x: x.to("cpu", copy=True), card)
    data = {d: lm_data(cfg, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, device=d)
            for d in ("cuda", "cpu")}

    def loss(p, b):
        return T.loss_fn(p, b["tokens"], b["labels"], cfg)

    b = next(lm_data(cfg, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, device="cpu"))
    grads = {}
    for d, p in (("cuda", card), ("cpu", cpu)):
        leaves = param_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        l, _ = loss(p, {k: v.to(leaves[0].device) for k, v in b.items()})
        grads[d] = [g.cpu() for g in torch.autograd.grad(l, leaves)]
        for t in leaves:
            t.requires_grad_(False)
    grad_rel = max(float((a - c).abs().max() / c.abs().max())
                   for a, c in zip(grads["cuda"], grads["cpu"]))
    check(grad_rel <= 1e-5, f"first-step gradients card vs CPU: {grad_rel}")
    lr = 1e-3
    ocfg = OptConfig(lr=lr, warmup_steps=1, total_steps=TRAIN_CPU_STEPS)
    tcfg = TrainConfig(steps=TRAIN_CPU_STEPS, log_every=1)
    (card, hc), (cpu, hp) = (train(loss, p, data[d], ocfg, tcfg)
                             for d, p in (("cuda", card), ("cpu", cpu)))
    loss_rel = max(abs(a["loss"] - c["loss"]) / abs(c["loss"])
                   for a, c in zip(hc, hp))
    check(len(hc) == len(hp) == TRAIN_CPU_STEPS and loss_rel <= 1e-5,
          f"training losses card vs CPU: {loss_rel}")
    diffs = [(a.cpu() - c).abs() for a, c in zip(param_leaves(card),
                                                  param_leaves(cpu))]
    param_max = max(float(x.max()) for x in diffs)
    bound = 2 * lr * TRAIN_CPU_STEPS
    check(param_max <= bound, f"parameters card vs CPU: {param_max} > "
          f"{bound}")
    n = sum(x.numel() for x in diffs)
    over = sum(int((x > 1e-6).sum()) for x in diffs)
    del card, cpu, grads
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype,
            "batch": TRAIN_CPU_BATCH,
            "seq": TRAIN_CPU_SEQ, "steps": TRAIN_CPU_STEPS,
            "first_step_grad_rel": grad_rel, "loss_rel": loss_rel,
            "losses_card": [h["loss"] for h in hc],
            "losses_cpu": [h["loss"] for h in hp],
            "param_max_abs_diff": param_max, "param_bound": bound,
            "param_share_over_1e-6": over / n,
            "param_median_abs_diff": float(np.median(
                torch.cat([x.flatten() for x in diffs]).numpy()))}


def _grads_of(loss, leaves):
    import torch
    for t in leaves:
        t.requires_grad_(True)
    g = torch.autograd.grad(loss(), leaves)
    for t in leaves:
        t.requires_grad_(False)
    return [x.cpu() for x in g]


def _rel_tree(a, b):
    """max |a - b| / max |b| over a pair of tensors."""
    return float((a.cpu().float() - b.float()).abs().max()
                 / b.float().abs().max())


def vision_card_vs_cpu():
    """Reduced vit-s16, deit-b, dit-b2 and efficientnet-b7 in fp32, drawn
    on the card and on the CPU (the draws bitwise equal) and run on both:
    logits (DiT: noise and sigma; EfficientNet: logits and the new
    batch-norm state in training mode) within 1e-5 of the largest |out|;
    the first step's gradients of each ``loss_fn`` within 1e-5 of each
    leaf's largest |grad|; DiT's ``sample`` (4 steps) within 1e-5, its
    adaLN-Zero leaves first set from a seeded draw on both devices.
    EfficientNet runs at 64 px, where the head's batch norm sees 16
    values a channel; its gradients flow back through seven batch norms
    in training mode and cuDNN's convolution backward sums in another
    order than the CPU's, so they are held to 5e-5 (1.67e-5 measured on
    an H100); the ``project`` batch norms' biases, whose gradient is
    zero in exact arithmetic, to 1e-5 of the model's largest |grad|.
    DiT's t_embed/w1 gradient is the timestep embedding times the
    upstream gradient; ``exp``, ``cos`` and ``sin`` part by ulps between
    the devices and t ≤ 999 magnifies them (2.84e-5 measured): 5e-5."""
    import numpy as np
    import torch
    from repro_torch.common import prng
    from repro_torch.common.config import reduced
    from repro_torch.common.device import resolve_device
    from repro_torch.models import dit as D
    from repro_torch.models import efficientnet as E
    from repro_torch.models import vit as V
    from repro_torch.train.checkpoint import flatten

    def same_draw(a, b):
        return all(torch.equal(x.cpu(), y) for x, y in
                   zip(_flat_tree(a), _flat_tree(b)))

    def imgs(B, res, seed):
        return torch.from_numpy(np.random.default_rng(seed).normal(
            size=(B, res, res, 3)).astype(np.float32))

    def grads_rel(card, cpu, loss, skip=(), loose=()):
        """(worst leaf's rel, its path, the ``skip`` leaves' largest
        |grad| over the model's, the worst of the ``loose`` leaves)."""
        gc = _grads_of(lambda: loss(card, dev), flatten(card)[0])
        gp = _grads_of(lambda: loss(cpu, host), flatten(cpu)[0])
        top = max(float(g.abs().max()) for g in gp)
        worst, zero, lax_ = (-1.0, ""), 0.0, 0.0
        for name, a, b in zip(_leaf_paths(cpu), gc, gp):
            if any(name.endswith(s) for s in skip):
                zero = max(zero, float(a.abs().max()) / top,
                           float(b.abs().max()) / top)
            elif name in loose:
                lax_ = max(lax_, _rel_tree(a, b))
            else:
                worst = max(worst, (_rel_tree(a, b), name))
        return worst[0], worst[1], zero, lax_

    out = {}
    dev, host = resolve_device("cuda"), torch.device("cpu")
    for arch in ("vit-s16", "deit-b"):
        cfg = reduced(vision_config(arch), dtype="float32")
        card, cpu = V.init(cfg, 0, dev), V.init(cfg, 0, host)
        check(same_draw(card, cpu), f"{arch}: the draw differs")
        x, y = imgs(4, cfg.img_res, 1), torch.tensor([0, 3, 7, 15])
        with torch.no_grad():
            rel = max(_rel_tree(V.forward(card, x.to(dev), cfg), V.forward(
                cpu, x, cfg)) for x in (x, imgs(2, 48, 2)))
        g, leaf, _, _ = grads_rel(card, cpu, lambda p, d: V.loss_fn(
            p, x.to(d), y.to(d), cfg)[0])
        out[arch] = {"logits_rel": rel, "grad_rel": g, "grad_leaf": leaf}
        check(rel <= 1e-5 and g <= 1e-5, f"{arch} card vs CPU: {out[arch]}")

    cfg = reduced(vision_config("efficientnet-b7"), dtype="float32")
    (card, cs), (cpu, ps) = (E.init(cfg, 0, d) for d in (dev, host))
    check(same_draw(card, cpu) and same_draw(cs, ps),
          "efficientnet-b7: the draw differs")
    x, y = imgs(4, 64, 3), torch.tensor([1, 5, 9, 2])
    res = {}
    for train in (False, True):
        with torch.no_grad():
            (a, sa), (b, sb) = (E.forward(p, s, x.to(d), cfg, train=train)
                                for p, s, d in ((card, cs, dev),
                                                (cpu, ps, host)))
        res["train" if train else "eval"] = _rel_tree(a, b)
        res["state_" + ("train" if train else "eval")] = max(
            float((u.cpu() - v).abs().max())
            for u, v in zip(_flat_tree(sa), _flat_tree(sb)))
    g, leaf, zero, _ = grads_rel(card, cpu, lambda p, d: E.loss_fn(
        p, cs if d == dev else ps, x.to(d), y.to(d), cfg)[0],
        skip=("project/bn/bias",))
    out["efficientnet-b7"] = dict(res, grad_rel=g, grad_leaf=leaf,
                                  zero_grad_rel=zero)
    check(max(res["eval"], res["train"], zero) <= 1e-5 and g <= 5e-5
          and max(res["state_eval"], res["state_train"]) <= 1e-5,
          f"efficientnet-b7 card vs CPU: {out['efficientnet-b7']}")

    cfg = reduced(vision_config("dit-b2"), dtype="float32")
    card, cpu = D.init(cfg, 0, dev), D.init(cfg, 0, host)
    check(same_draw(card, cpu), "dit-b2: the draw differs")
    keys = prng.split(prng.key(5), 64)
    i = 0
    for a, b in zip(_flat_tree(card), _flat_tree(cpu)):
        if not bool(b.any()):           # adaLN-Zero: a seeded draw
            b.copy_(prng.normal(keys[i], b.shape) * 0.05)
            a.copy_(b)
            i += 1
    lat = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 4, 4, 4)).astype(np.float32))
    t, yl = torch.tensor([0, 421, 999]), torch.tensor([0, 7, 16])
    with torch.no_grad():
        (na, sa), (nb, sb) = (D.forward(p, lat.to(d), t.to(d), yl.to(d), cfg)
                              for p, d in ((card, dev), (cpu, host)))
        sample = _rel_tree(
            D.sample(card, prng.key(3), yl.to(dev), cfg, cfg.img_res, 4),
            D.sample(cpu, prng.key(3), yl, cfg, cfg.img_res, 4))
    g, leaf, _, t_w1 = grads_rel(card, cpu, lambda p, d: D.loss_fn(
        p, lat.to(d), yl.to(d), prng.key(11), cfg)[0],
        loose=("t_embed/w1",))
    out["dit-b2"] = {"noise_rel": _rel_tree(na, nb),
                     "sigma_rel": _rel_tree(sa, sb), "grad_rel": g,
                     "grad_leaf": leaf, "t_embed_w1_grad_rel": t_w1,
                     "sample_rel": sample, "perturbed_leaves": i}
    check(max(out["dit-b2"][k] for k in ("noise_rel", "sigma_rel",
                                         "grad_rel", "sample_rel")) <= 1e-5
          and t_w1 <= 5e-5,
          f"dit-b2 card vs CPU: {out['dit-b2']}")
    torch.cuda.empty_cache()
    return out


def _leaf_paths(tree, prefix=""):
    """The leaves' paths ("a/b/0/c") in ``flatten``'s order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


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

# argv: the tree's src, the stream names (JSON), the seconds of each
COMPARE_MULTISTREAM = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from repro_torch.common.config import CHEAP_CNNS
from repro_torch.core.ingest import IngestConfig
from repro_torch.core.streaming import make_sharded_runner
from repro_torch.data.video import get_stream
from repro_torch.hopper import ops
from repro_torch.launch.mesh import make_ingest_mesh
from repro_torch.models import cnn
names, duration, n_chunks = json.loads(sys.argv[2]), int(sys.argv[3]), 4
mcfg = CHEAP_CNNS["cheap1"]
forward = cnn.make_forward(cnn.build(mcfg, cnn.init_params(mcfg, seed=0),
                                     "cuda"))
streams = {nm: get_stream(nm, duration_s=duration, fps=30).objects_array()[:2]
           for nm in names}
n_objects = sum(len(c) for c, _ in streams.values())
bounds = {nm: np.linspace(0, len(c), n_chunks + 1).astype(int)
          for nm, (c, _) in streams.items()}
rounds = [{nm: (c[bounds[nm][r]:bounds[nm][r + 1]],
                f[bounds[nm][r]:bounds[nm][r + 1]])
           for nm, (c, f) in streams.items()} for r in range(n_chunks)]
sunk = {nm: hashlib.sha256() for nm in names}


def sink(name, objs, vals, idxs):
    for a in (objs, vals, idxs):
        sunk[name].update(a.tobytes())


runner = make_sharded_runner(forward, make_ingest_mesh(1), names,
                             cfg=IngestConfig(K=1000, threshold=0.4),
                             topk_sink=sink, n_local_classes=1000,
                             cheap_flops_per_image=mcfg.flops_per_image())
torch.cuda.synchronize()
ops.reset_launches()
t0 = time.perf_counter()
for chunks in rounds:
    runner.feed(chunks)
    runner.flush()
got = runner.finish()
torch.cuda.synchronize()
wall = time.perf_counter() - t0
h = hashlib.sha256()
for nm in names:
    for suffix, data in got[nm][0].save_bytes():
        h.update(suffix.encode())
        h.update(data)
    h.update(sunk[nm].digest())
print(json.dumps({"wall_s": wall, "objects": n_objects,
                  "objects_per_s": n_objects / wall,
                  "steps": runner.pipeline.stats.n_steps,
                  "launches": dict(ops.LAUNCHES),
                  "bytes_and_sinks_sha256": h.hexdigest()}))
"""


def _turns(code, trees, argv, rounds=1):
    """``code`` run by the parent tree and by this checkout in turns
    parent, change, change, parent (``rounds`` times), each in a process
    of its own; each run's last line of output, parsed."""
    runs = []
    for tree in ("parent", "change", "change", "parent") * rounds:
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
    identical in all four runs. Then the eight 120 s streams of
    ``multistream_path`` through the sharded runner on
    ``make_ingest_mesh(1)`` in eight turns (wall, objects/s, launches;
    every stream's bytes and sink identical). Last, the kernels both trees have, timed
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
    # two rounds: the path is paced by the host (the unmatched tail's
    # per-row scan), whose speed varies between processes
    runs = _turns(COMPARE_MULTISTREAM, trees,
                  [json.dumps(list(MULTI_STREAMS)), "120"], rounds=2)
    check(len({r["bytes_and_sinks_sha256"] for r in runs}) == 1,
          "multistream_8x120s: parent and change save other bytes")
    emit({"phase": "compare_multistream_8x120s", "gpu": smi, "runs": runs,
          "bytes_identical": True, "elapsed_s": elapsed()})
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
    from repro_torch.common.config import CHEAP_CNNS, reduced
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
        entry["launches_multistream_two_blocks"] = \
            multi["two_blocks"]["launches"][entry["name"]]
        entry["launches_mesh_serve"] = mesh_serve[entry["name"]]
    dq["launches"] = archive["dequant_topk"]
    tk["launches"] = pipe["launches"]["topk"]
    tk["launches_multistream"] = multi["launches"]["topk"]
    tk["launches_multistream_two_blocks"] = \
        multi["two_blocks"]["launches"]["topk"]
    lm = lm_path(ops, peaks, lm_config())
    emit({"phase": "lm_path", "gpu": smi, **lm, "elapsed_s": elapsed()})
    fa["launches"] = lm["launches"]["flash_attention"]
    moe = moe_path(ops, peaks)
    emit({"phase": "moe_path", "gpu": smi, **moe, "elapsed_s": elapsed()})
    fa["launches_moe_path"] = moe["launches"]["flash_attention"]
    tk["launches_moe_path"] = moe["launches"]["topk"]
    for arch, m in moe["models"].items():
        own = m["prefill_flash_" + lm_config(arch).moe_dispatch]
        tk["router"].setdefault("launches_per_prefill", {})[arch] = \
            own["launches_per_call"]["topk"]
    trained = train_path(ops, peaks)
    emit({"phase": "train_path", "gpu": smi, **trained,
          "elapsed_s": elapsed()})
    for entry in (ca, pm, dq, tk, mg, fa):
        entry["launches_train_path"] = trained["launches"][entry["name"]]
    emit({"phase": "train_resume", "gpu": smi, **train_resume(),
          "elapsed_s": elapsed()})
    built = steps_path(ops, peaks)
    for cell in built["cells"]:
        emit({"phase": "steps_path", "gpu": smi, **cell,
              "elapsed_s": elapsed()})
    emit({"phase": "steps_path", "gpu": smi, "launches": built["launches"],
          "path_s": built["path_s"], "elapsed_s": elapsed()})
    fa["launches_steps_path"] = built["launches"]["flash_attention"]
    tk["launches_steps_path"] = built["launches"]["topk"]
    long_s = long_prefill_checks(ops, peaks)
    emit({"phase": "steps_path_checks", "gpu": smi, **long_s,
          "elapsed_s": elapsed()})
    fa["steps_path_s32768"] = long_s["flash_attention"]
    t_vision = time.perf_counter()
    vision = vision_path(ops, peaks)
    for model in ("vit-l16", "deit-b", "dit-b2", "efficientnet-b7"):
        emit({"phase": "vision_path", "model": model, "gpu": smi,
              **vision[model], "elapsed_s": elapsed()})
    emit({"phase": "vision_path", "gpu": smi,
          "launches": vision["launches"],
          "path_s": time.perf_counter() - t_vision, "elapsed_s": elapsed()})
    for entry in (ca, pm, dq, tk, mg, fa):
        entry["launches_vision_path"] = vision["launches"][entry["name"]]
    meshed = mesh_path(ops, peaks)
    emit({"phase": "mesh_path", "gpu": smi, **meshed,
          "elapsed_s": elapsed()})
    fa["launches_mesh_path"] = meshed["launches"]["flash_attention"]
    tk["launches_mesh_path"] = meshed["launches"]["topk"]
    # the gate tune on the card, then the dry run in subprocesses (after
    # the gate's timed run, so that their tracing loads no host core of it)
    t_two = time.perf_counter()
    gated = gate_tune_path(ops, ref)
    emit({"phase": "gate_tune_path", "gpu": smi, **gated,
          "elapsed_s": elapsed()})
    with tempfile.TemporaryDirectory() as dry_dir:
        dried = dryrun_finish(dryrun_start(dry_dir), dry_dir,
                              time.perf_counter())
    emit({"phase": "dryrun_path", "gpu": smi, **dried,
          "two_phases_s": time.perf_counter() - t_two,
          "elapsed_s": elapsed()})
    for entry in (ca, pm):
        entry["launches_gate_tune_path"] = gated["launches"][entry["name"]]

    # -- phase 4: card against CPU --------------------------------------------
    emit({"phase": "card_vs_cpu", **card_vs_cpu(serve_args),
          "bgsub": bgsub_card_vs_cpu(gate_boxes, gate_bg),
          "selection": selection_card_vs_cpu(),
          "training": train_card_vs_cpu(), "lm": lm_card_vs_cpu(),
          "lm_training": train_card_vs_cpu_lm(
              lm_config(n_layers=LM_CPU_LAYERS, dtype="float32")),
          "moe_training": train_card_vs_cpu_lm(
              reduced(lm_config(MOE_ARCHS[0][0]), dtype="float32",
                      remat=True)),
          "vision": vision_card_vs_cpu(), "elapsed_s": elapsed()})
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
               "multistream_8x120s": multi["launches"][name],
               "multistream_two_blocks_8x30s":
                   multi["two_blocks"]["launches"][name]}
        for name in ("pixel_match", "centroid_assign")}})
    emit({"kernels": [ca, pm, dq, tk, mg, fa]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
