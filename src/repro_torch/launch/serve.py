"""Multi-tenant Focus serving entry point on the card (the paper's deployment
shape, §5).

Per stream: sample -> GT-label -> specialize cheap CNNs -> parameter
selection (§4.4) -> ingest (pixel differencing -> cheap CNN -> fused
clustering -> top-K index) -> serve
``--rounds`` rounds in which ``--tenants`` tenants each submit the
stream's dominant-class workload through a ``QueryService``: a continuous
batcher merges every in-flight request into ONE ``query_many`` / GT pass
per cycle (answers byte-identical to serving each request alone), and
per-tenant latency percentiles are reported at the end.

  python -m repro_torch.launch.serve --stream jacksonh --duration 60 \\
      --fps 30 --tenants 4 --rounds 3

By default the path is the JAX package's: the three specialized cheap
CNNs ``spec1``-``spec3`` (``launch.zoo``) are trained on the stream's
top ``--ls`` classes + OTHER for ``--steps`` steps (or loaded from the
zoo's cache), ``core.params.sweep`` evaluates every (model, K in {1,2,4},
T in {0.5,0.8}) against the generator's labels, and ``select`` picks one
by ``--policy`` (the best recall when no configuration is viable). The
stream is then ingested with the chosen model, its class map and
``IngestConfig(K, T, max_clusters=2048)``.

``--K`` and ``--T`` together override the selection: the cheap CNN is
then ``--model`` (default ``cheap1``) with weights drawn from ``--seed``
(default 0), or loaded with ``--weights FILE.npz`` (a JAX parameter tree
saved as numpy, see ``models.cnn.save_npz_params``), and nothing is
trained. The GT-CNN is the stream's exact prototype oracle
(``data.video.gt_oracle``). Everything runs on ``--device`` (default
``cuda``).

With ``--stream-chunks N`` the ingest runs *streaming*: the stream's
chunks are offered to the service, which arbitrates the device between
ingest and the tenants' queries per ``--service-policy`` — ``query``
protects query SLOs (chunks wait in a bounded backlog, shedding the
oldest on overflow per ``--ingest-backlog``), ``ingest`` runs chunks
first and lets admission control shed query overflow instead. Every
chunk that ingests is prefetched into the GT-label cache, so warm
queries between chunks stay off the GT-CNN path.

With ``--archive DIR`` the ingest additionally rolls the live index over
into time shards (``--shard-objects`` each) sealed under DIR in the v4
quantized format, and the service queries through an
``ArchiveQueryEngine``: merged batches fan out across every sealed shard
plus the live one, with a single GT-CNN pass over the uncached
candidates of all shards. Sealed shards are ranked on the card by the
``dequant_topk`` kernel, once per residency in the shard cache
(``--shard-cache-mb``).

  python -m repro_torch.launch.serve --stream jacksonh --duration 600 \\
      --fps 30 --archive /tmp/arch --stream-chunks 8

With ``--mesh-devices N`` the streaming or archive ingest goes through a
``ShardedIngestPipeline`` over ``launch.mesh.make_ingest_mesh(N)`` on
``--device`` (the multi-stream stacked step, here with one stream's
slot), running the model's tensor-level forward. On the card N is 1:
ingest over more than one card is not built; ``--device cpu`` takes any
N.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.common.config import CHEAP_CNNS
from repro_torch.core.archive import ArchiveQueryEngine, ShardCatalog
from repro_torch.core.engine import QueryEngine
from repro_torch.core.ingest import IngestConfig, ingest
from repro_torch.core.params import select, sweep
from repro_torch.core.query import (dominant_classes, gt_frames_by_class,
                                    precision_recall)
from repro_torch.core.pipeline import ShardedIngestPipeline
from repro_torch.core.streaming import StreamingIngestor, StreamPlacement
from repro_torch.data.video import get_stream, gt_oracle
from repro_torch.launch import zoo
from repro_torch.launch.mesh import make_ingest_mesh
from repro_torch.models import cnn
from repro_torch.serve import QueryService, ServiceConfig


def _mk_service(engine, args, ingestor=None) -> QueryService:
    cfg = ServiceConfig(
        max_queue_depth=args.queue_depth,
        max_batch_requests=args.batch_requests,
        policy=args.service_policy,
        max_ingest_backlog=(args.ingest_backlog
                            if args.ingest_backlog > 0 else None),
        default_deadline_s=(args.slo_ms / 1e3 if args.slo_ms > 0 else None))
    return QueryService(engine, cfg, ingestor=ingestor)


def _serve_round(service: QueryService, n_tenants: int, workload):
    """Submit one request per tenant — the shared dominant-class workload,
    rotated per tenant so the overlap the batcher dedupes is explicit —
    and pump the service idle. Returns (responses by tenant, wall_s)."""
    t0 = time.perf_counter()
    for t in range(n_tenants):
        rot = t % max(len(workload), 1)
        service.submit(f"tenant{t}",
                       list(workload[rot:]) + list(workload[:rot]))
    by_tenant = {}
    for resp in service.run_until_idle():
        by_tenant[resp.request.tenant] = resp
    return by_tenant, time.perf_counter() - t0


def _round_line(tag, service, by_tenant, wall, gt_delta):
    n_req = len(by_tenant)
    n_cls = sum(len(r.results) for r in by_tenant.values())
    qps = n_cls / max(wall, 1e-9)
    batch = service.last_batch
    merged = (f"{batch.n_unique_candidates} unique candidates, "
              f"{batch.n_cache_hits} cached"
              if batch is not None and n_req else "no batch ran")
    print(f"[serve] {tag}: {n_req} tenants x {max(n_cls // max(n_req, 1), 0)}"
          f" classes in {wall*1e3:.0f}ms ({qps:.1f} QPS) | "
          f"{service.stats.n_shared_queries} shared pairs lifetime | "
          f"{merged}, {gt_delta} GT-CNN calls | p99 "
          f"{service.slo.percentile_s(99.0)*1e3:.1f}ms")


def _mk_ingestor(apply_fn, flops, cfg, args, **kw) -> StreamingIngestor:
    """The stream's ingestor: host-staged through ``apply_fn``, or with
    ``--mesh-devices N`` bound to its slot of a ``ShardedIngestPipeline``
    over an N-block ingest mesh on ``--device``, running
    ``apply_fn.forward`` (the tensor-level forward)."""
    if args.mesh_devices <= 0:
        return StreamingIngestor(apply_fn, flops, cfg, device=args.device,
                                 **kw)
    mesh = make_ingest_mesh(args.mesh_devices, device=args.device)
    if torch.device(args.device).index not in (None, mesh.devices[0].index):
        raise SystemExit(f"--mesh-devices builds its mesh from "
                         f"{mesh.devices[0]}, but the model runs on "
                         f"--device {args.device}")
    placement = StreamPlacement([args.stream], mesh.size)
    shared = ShardedIngestPipeline(apply_fn.forward, mesh, placement.slots,
                                   cfg=cfg)
    return StreamingIngestor(
        None, flops, cfg, pipeline=shared.handle(args.stream),
        device=mesh.devices[placement.device_of(args.stream)], **kw)


def _streaming_ingest(crops, frames, apply_fn, flops, cfg, class_kw,
                      workload, gt_apply, n_chunks, args):
    """Offer the stream's chunks to the service while tenants query
    between chunks from the live, still-growing index (query-while-
    ingest). Returns (index, stats, engine, service) — the engine's
    GT-label cache stays warm for the post-ingest query rounds."""
    ing = _mk_ingestor(apply_fn, flops, cfg, args, **class_kw)
    engine = QueryEngine(ing.index, gt_apply=gt_apply,
                         gt_flops_per_image=zoo.GT_FLOPS)
    service = _mk_service(engine, args, ingestor=ing)
    bounds = np.linspace(0, len(crops), n_chunks + 1).astype(int)
    for rnd, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        service.offer_ingest(crops[lo:hi], frames[lo:hi])
        gt0 = engine.stats.n_gt_invocations
        chunks0 = service.stats.n_ingest_chunks
        by_tenant, wall = _serve_round(service, args.tenants, workload)
        print(f"[serve] chunk {rnd}: +{hi - lo} objs offered "
              f"({service.stats.n_ingest_chunks - chunks0} ingested, "
              f"{service.pending_ingest} deferred, "
              f"{service.stats.n_ingest_shed_chunks} shed lifetime) | "
              f"{service.stats.n_prefetch_gt} prefetched GT lifetime")
        _round_line(f"chunk {rnd}", service, by_tenant, wall,
                    engine.stats.n_gt_invocations - gt0)
    service.drain_ingest()
    index, stats = ing.finish()
    engine.prefetch(ing.flush().touched_cids)
    return index, stats, engine, service


def _archive_ingest(crops, frames, apply_fn, flops, cfg, class_kw,
                    workload, gt_apply, n_chunks, args):
    """Streaming ingest with shard rollover; merged tenant batches fan out
    across sealed shards + the live index through an
    ``ArchiveQueryEngine``. Returns (catalog, stats, engine, service)."""
    catalog = ShardCatalog.open(args.archive)
    ing = _mk_ingestor(apply_fn, flops, cfg, args, catalog=catalog,
                       shard_objects=args.shard_objects, **class_kw)
    cache_kw = ({"capacity": args.shard_cache} if args.shard_cache > 0
                else {"capacity_bytes": args.shard_cache_mb << 20})
    engine = ArchiveQueryEngine(catalog, gt_apply=gt_apply, ingestor=ing,
                                gt_flops_per_image=zoo.GT_FLOPS,
                                device=args.device, **cache_kw)
    service = _mk_service(engine, args, ingestor=ing)
    bounds = np.linspace(0, len(crops), n_chunks + 1).astype(int)
    for rnd, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        service.offer_ingest(crops[lo:hi], frames[lo:hi])
        gt0 = engine.stats.n_gt_invocations
        by_tenant, wall = _serve_round(service, args.tenants, workload)
        batch = service.last_batch
        shards = (f"{batch.n_shards} shards, {batch.n_shard_loads} loads"
                  if batch is not None else "no batch")
        print(f"[serve] chunk {rnd}: +{hi - lo} objs offered | "
              f"{len(catalog)} shards sealed ({shards}) | "
              f"{service.stats.n_prefetch_gt} prefetched GT lifetime")
        _round_line(f"chunk {rnd}", service, by_tenant, wall,
                    engine.stats.n_gt_invocations - gt0)
    service.drain_ingest()
    ing.finish()
    engine.prefetch(ing.flush())
    return catalog, ing.stats, engine, service


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stream", default="lausanne")
    ap.add_argument("--policy", default="balance",
                    choices=["balance", "opt_ingest", "opt_query"],
                    help="§4.4 selection policy over the swept configs")
    ap.add_argument("--duration", type=int, default=60)
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--ls", type=int, default=6,
                    help="classes each specialized CNN keeps (+ OTHER)")
    ap.add_argument("--steps", type=int, default=150,
                    help="training steps of each specialized CNN")
    ap.add_argument("--K", type=int, default=None,
                    help="override: ingest with this K (needs --T) and the "
                         "--model CNN instead of selecting")
    ap.add_argument("--T", type=float, default=None,
                    help="override: ingest with this threshold (needs --K)")
    ap.add_argument("--model", default=None, choices=sorted(CHEAP_CNNS),
                    help="override only: the cheap CNN (default cheap1)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override only: seed of the cheap CNN's random "
                         "weights (default 0)")
    ap.add_argument("--weights", default=None, metavar="FILE.npz",
                    help="override only: load the cheap CNN's JAX "
                         "parameters saved as numpy")
    ap.add_argument("--rounds", type=int, default=3,
                    help="query-workload rounds (round 1 is cold, the rest "
                         "exercise the warm GT-label cache)")
    ap.add_argument("--tenants", type=int, default=4,
                    help="concurrent tenants submitting the query workload "
                         "each round")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="per-request latency SLO deadline in ms "
                         "(0 = no deadline accounting)")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="admission bound on queued requests")
    ap.add_argument("--batch-requests", type=int, default=32,
                    help="max requests merged into one batch cycle")
    ap.add_argument("--service-policy", default="query",
                    choices=["query", "ingest"],
                    help="backpressure policy when ingest and queries "
                         "contend: 'query' defers/sheds ingest chunks, "
                         "'ingest' runs chunks first and sheds query "
                         "overflow via admission control")
    ap.add_argument("--ingest-backlog", type=int, default=0,
                    help="max deferred ingest chunks before the oldest is "
                         "shed (0 = unbounded, never shed)")
    ap.add_argument("--stream-chunks", type=int, default=0,
                    help="feed the stream in N chunks and serve the query "
                         "workload between chunks (query-while-ingest); "
                         "0 = one-shot ingest (8 chunks with --archive)")
    ap.add_argument("--archive", default=None, metavar="DIR",
                    help="time-sharded archive mode: seal shards into DIR "
                         "during ingest and serve queries through the "
                         "cross-shard ArchiveQueryEngine")
    ap.add_argument("--shard-objects", type=int, default=2048,
                    help="archive mode: objects per sealed shard")
    ap.add_argument("--shard-cache", type=int, default=0,
                    help="archive mode: LRU capacity in resident shard "
                         "COUNT (deprecated bound; 0 = use --shard-cache-mb)")
    ap.add_argument("--shard-cache-mb", type=int, default=256,
                    help="archive mode: LRU capacity in MiB of resident "
                         "shard heap state (ignored when --shard-cache > 0)")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="ingest through the sharded multi-stream pipeline "
                         "over an ingest mesh of N blocks on --device (0 = "
                         "host-staged ingest); needs --stream-chunks or "
                         "--archive; one card, any N on the CPU")
    ap.add_argument("--index-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh_devices > 0 and not (args.archive or args.stream_chunks > 0):
        ap.error("--mesh-devices needs a streaming ingest path: pass "
                 "--stream-chunks N and/or --archive DIR")
    if (args.K is None) != (args.T is None):
        ap.error("--K and --T override the selection together: give both "
                 "or neither")
    if args.K is None and (args.model is not None or args.seed is not None
                           or args.weights is not None):
        ap.error("--model, --seed and --weights belong to the --K/--T "
                 "override")
    return args


def _select(args, crops, frames, labels):
    """§4.4: train (or load) the specialized family, sweep (model, K, T),
    select by ``--policy``. Returns (apply_fn, accounted flops, class map,
    IngestConfig, report)."""
    models, cmaps, trained = {}, {}, {}
    for mid in zoo.SPECIALIZED_FAMILY:
        apply_fn, acc_flops, cmap = zoo.get_model(
            args.stream, mid, crops, labels, args.duration, steps=args.steps,
            Ls=args.ls, device=args.device)
        models[mid] = (apply_fn, acc_flops)
        cmaps[mid] = cmap
        trained[mid] = {"train_s": apply_fn.train_s,
                        "history": apply_fn.history}
        if apply_fn.history:
            h0, h1 = apply_fn.history[0], apply_fn.history[-1]
            print(f"[serve] trained {mid} in {apply_fn.train_s:.1f}s: loss "
                  f"{h0['loss']:.3f} -> {h1['loss']:.3f}, acc "
                  f"{h0['acc']:.3f} -> {h1['acc']:.3f}")
        else:
            print(f"[serve] loaded {mid} from the model cache")
    t0 = time.perf_counter()
    evals = sweep(crops, frames, labels, models, Ks=[1, 2, 4], Ts=[0.5, 0.8],
                  gt_flops=zoo.GT_FLOPS, class_maps=cmaps, max_clusters=2048,
                  device=args.device)
    sweep_s = time.perf_counter() - t0
    choice = select(evals, args.policy) or max(
        evals, key=lambda e: (e.recall, e.precision))
    print(f"[serve] policy={args.policy} -> model={choice.candidate.model_id}"
          f" K={choice.candidate.K} T={choice.candidate.T} "
          f"(P={choice.precision:.3f} R={choice.recall:.3f})")
    mid = choice.candidate.model_id
    cfg = IngestConfig(K=choice.candidate.K, threshold=choice.candidate.T,
                       max_clusters=2048)
    report = {"models": trained, "sweep_s": sweep_s, "policy": args.policy,
              "choice": {"model": mid, "K": choice.candidate.K,
                         "T": choice.candidate.T,
                         "precision": choice.precision,
                         "recall": choice.recall, "viable": choice.viable}}
    return models[mid][0], models[mid][1], cmaps[mid], cfg, report


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the serve path; prints per-round and per-tenant lines and returns a
    summary of the run (counts, ingest rate, per-tenant latencies)."""
    args = parse_args(argv)
    vs = get_stream(args.stream, duration_s=args.duration, fps=args.fps)
    crops, frames, _, labels = vs.objects_array()
    print(f"[serve] stream={args.stream} objects={len(crops)} "
          f"classes={len(np.unique(labels))}")

    if args.K is None:
        apply_fn, flops, class_map, cfg, selection = _select(
            args, crops, frames, labels)
        class_kw = {"class_map": class_map}
    else:
        model_id = args.model or "cheap1"
        mcfg = CHEAP_CNNS[model_id]
        seed = args.seed if args.seed is not None else 0
        tree = (cnn.load_npz_params(args.weights) if args.weights
                else cnn.init_params(mcfg, seed=seed))
        model = cnn.build(mcfg, tree, device=args.device)
        apply_fn = cnn.make_apply(model)
        apply_fn.forward = cnn.make_forward(model)
        flops = mcfg.flops_per_image()
        cfg = IngestConfig(K=args.K, threshold=args.T)
        class_kw = {"n_local_classes": mcfg.n_classes}
        selection = None
        origin = (f"weights {args.weights}" if args.weights
                  else f"seed {seed}")
        print(f"[serve] model={model_id} ({origin}) K={cfg.K} "
              f"T={cfg.threshold} M={cfg.max_clusters} device={args.device}")

    gt_apply = gt_oracle(labels)
    workload = [int(x) for x in dominant_classes(labels)]
    streaming = bool(args.archive) or args.stream_chunks > 0
    n_chunks = args.stream_chunks if args.stream_chunks > 0 else 8
    if streaming:
        # freshness scales with the CNN batch cut: size batches to the
        # chunk so each round actually publishes (the partition is still a
        # function of the stream alone, not of the chunking)
        chunk = max(1, -(-len(crops) // n_chunks))
        cfg = dataclasses.replace(
            cfg, batch_size=max(16, min(cfg.batch_size, chunk)))
    ingest_args = (crops, frames, apply_fn, flops, cfg, class_kw, workload,
                   gt_apply, n_chunks, args)
    t0 = time.perf_counter()
    index = catalog = None
    if args.archive:
        catalog, stats, engine, service = _archive_ingest(*ingest_args)
    elif args.stream_chunks > 0:
        index, stats, engine, service = _streaming_ingest(*ingest_args)
    else:
        index, stats = ingest(crops, frames, apply_fn, flops, cfg,
                              device=args.device, **class_kw)
        engine = QueryEngine(index, gt_apply=gt_apply,
                             gt_flops_per_image=zoo.GT_FLOPS)
        service = _mk_service(engine, args)
    # streaming modes interleave query rounds with the ingest, so their
    # ingest time is the ingestor's own accounted wall
    ingest_s = stats.wall_s if streaming else time.perf_counter() - t0
    if catalog is not None:
        n_clusters = sum(m.n_clusters for m in catalog)
        n_members = sum(m.n_objects for m in catalog)
        where = f" in {len(catalog)} shards sealed under {args.archive}"
    else:
        n_clusters, n_members, where = index.n_clusters, index.n_objects, ""
    print(f"[serve] ingest: {n_clusters} clusters / {n_members} objects"
          f"{where} in {ingest_s:.1f}s "
          f"({len(crops) / max(ingest_s, 1e-9):.1f} objects/s) | "
          f"{stats.n_cnn_invocations} CNN'd, {stats.n_pixel_dedup} "
          f"pixel-dedup, {stats.n_evictions} evicted | cheap CNN "
          f"{stats.cheap_flops / 1e9:.1f} GFLOP")
    if args.index_out:
        if index is None:
            print("[serve] --index-out ignored: archive shards are already "
                  "persisted through the catalog")
        else:
            index.save(args.index_out)
            print(f"[serve] index persisted to {args.index_out}.*")

    # steady-state traffic: every round, all tenants submit the dominant-
    # class workload; the service merges each round's in-flight requests
    # into one union + one GT-CNN pass, centroid verdicts cached across
    # rounds. In streaming modes the chunk rounds' service carries its warm
    # GT-label cache straight into these rounds.
    gtf = gt_frames_by_class(labels, frames)
    ps, rs, rounds = [], [], []
    answers = {}
    for rnd in range(max(args.rounds, 1)):
        gt0 = engine.stats.n_gt_invocations
        by_tenant, wall = _serve_round(service, args.tenants, workload)
        if not by_tenant:
            continue
        n_cls = sum(len(r.results) for r in by_tenant.values())
        rounds.append({"round": rnd, "wall_s": wall, "n_class_queries": n_cls,
                       "gt_calls": engine.stats.n_gt_invocations - gt0})
        _round_line(f"round {rnd}", service, by_tenant, wall,
                    engine.stats.n_gt_invocations - gt0)
        if rnd > 0:
            continue                  # accuracy identical across rounds
        resp0 = by_tenant.get("tenant0")
        if resp0 is None:
            continue
        for x, res in zip(workload, resp0.results):
            answers[x] = res.frames
            p, r = precision_recall(res.frames, gtf.get(x, np.array([])))
            ps.append(p)
            rs.append(r)
            print(f"  query class={x:4d}: {len(res.frames):5d} frames, "
                  f"{res.n_candidate_clusters:4d} candidates, "
                  f"{res.n_gt_invocations:4d} fresh GT-CNN calls "
                  f"P={p:.3f} R={r:.3f}")

    if not ps:
        print("[serve] no queries served (empty dominant-class workload "
              "or no surviving objects)")
    else:
        print(f"[serve] avg P={np.mean(ps):.3f} R={np.mean(rs):.3f} | "
              f"lifetime GT calls {engine.stats.n_gt_invocations} for "
              f"{engine.stats.n_candidates} served candidates")
    svc = service.stats
    print(f"[serve] service: {svc.n_completed} requests "
          f"({svc.n_rejected} rejected) in {svc.n_merged_calls} merged "
          f"calls | {svc.n_merged_queries} unique pairs, "
          f"{svc.n_shared_queries} shared | ingest {svc.n_ingest_chunks} "
          f"chunks ({svc.n_ingest_deferred} chunk-cycles deferred, "
          f"{svc.n_ingest_shed_chunks} shed)")
    tenants = {}
    for ts in service.slo:
        p50 = f"{ts.p50_s*1e3:.1f}" if ts.latencies_s else "-"
        p99 = f"{ts.p99_s*1e3:.1f}" if ts.latencies_s else "-"
        print(f"  {ts.tenant}: {ts.n_completed}/{ts.n_submitted} served "
              f"p50={p50}ms p99={p99}ms deadline_missed="
              f"{ts.n_deadline_missed} rejected={ts.n_rejected}")
        tenants[ts.tenant] = {"completed": ts.n_completed,
                              "p50_ms": ts.p50_s * 1e3,
                              "p99_ms": ts.p99_s * 1e3}
    summary = {
        "stream": args.stream, "objects": int(len(crops)),
        "K": cfg.K, "T": cfg.threshold, "selection": selection,
        "uniques": stats.n_cnn_invocations,
        "pixel_dedup": stats.n_pixel_dedup,
        "clusters": n_clusters, "evictions": stats.n_evictions,
        "ingest_s": ingest_s,
        "ingest_objects_per_s": len(crops) / max(ingest_s, 1e-9),
        "ingest_chunks": svc.n_ingest_chunks,
        "rounds": rounds, "tenants": tenants,
        "precision": float(np.mean(ps)) if ps else None,
        "recall": float(np.mean(rs)) if rs else None,
        "answers": answers,
    }
    if catalog is not None:
        st = engine.stats
        print(f"[serve] shard cache: {st.resident_bytes / 2**20:.2f} MiB "
              f"resident | {st.n_shard_loads} loads, {st.n_shard_hits} "
              f"hits ({st.shard_hit_rate:.0%}), {st.n_shard_evictions} "
              f"evictions")
        summary.update(shards=len(catalog), shard_loads=st.n_shard_loads,
                       shard_hits=st.n_shard_hits,
                       shard_evictions=st.n_shard_evictions,
                       resident_bytes=st.resident_bytes)
    return summary


if __name__ == "__main__":
    main()
