"""Perf hillclimb harness: a port of ``repro.launch.hillclimb``.

Cell mode re-traces ONE (arch x shape) cell of the dry run with config
overrides and prints its roofline terms: the measurement step of the
hypothesis -> change -> measure -> validate loop.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --cell olmo-1b:train_4k \\
      --set act_sharding=dp train_microbatches=2 --tag no-sp

``--gate`` tunes the ingest redundancy gate and frame stride instead
(``gate_tune``): on the card by default, ``--device cpu`` for the plain
versions.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --gate
"""
import argparse
import json
import os


def parse_override(kv: str):
    """``k=v`` -> (k, v): v as an int, else a float, else true/false as a
    bool, else the string."""
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("true", "false"):
        return k, v == "true"
    return k, v


def gate_tune(n_frames: int = 240, objs_per_frame: int = 4,
              window_frames: int = 30, dup_rate: float = 0.9,
              seed: int = 0, device: str = "cuda") -> dict:
    """Hillclimb the ingest gate: run the AdaptiveSampler against a
    static-camera synthetic stream, window by window, probing recall vs.
    ungated ingest at every step (the recall gate). Returns the stride /
    duplicate-rate / recall trajectory plus the final operating point,
    key for key the JAX package's record.

    On the card the gate's and the tracker's matches run the
    ``pixel_match`` kernel and the clustering ``centroid_assign``."""
    import numpy as np

    from repro_torch.core.ingest import IngestConfig, ingest
    from repro_torch.core.params import AdaptiveSampler, SamplerConfig
    from repro_torch.core.streaming import StreamingIngestor

    rng = np.random.default_rng(seed)
    n_classes, feat = 5, 16
    base = rng.random((8, 16, 16, 3)).astype(np.float32)

    def cheap(crops):
        b = len(crops)
        cls = (crops[:, 0, 0, 0] * n_classes).astype(int) % n_classes
        probs = np.eye(n_classes, dtype=np.float32)[cls] * 0.9 + 0.02
        feats = np.zeros((b, feat), np.float32)
        feats[np.arange(b), cls % feat] = 1.0
        return probs, feats

    crops, frames = [], []
    for f in range(n_frames):
        for k in rng.choice(len(base), objs_per_frame, replace=False):
            c = base[k]
            if rng.random() > dup_rate:      # fresh content, not a dup
                c = rng.random(c.shape).astype(np.float32)
            crops.append(c)
            frames.append(f)
    crops = np.stack(crops)
    frames = np.array(frames, np.int64)

    cfg = IngestConfig(K=3, batch_size=64, gate=True, gate_threshold=0.01)
    idx_un, _ = ingest(crops, frames, cheap, 1.0, cfg,
                       n_local_classes=n_classes, device=device)

    def frames_by_class(idx):
        return {c: set(np.asarray(idx.frames_of(idx.lookup(c))).tolist())
                for c in range(n_classes)}

    ref = frames_by_class(idx_un)
    sampler = AdaptiveSampler(SamplerConfig())
    ing = StreamingIngestor(cheap, 1.0, cfg, n_local_classes=n_classes,
                            device=device)
    steps = []
    for lo in range(0, n_frames, window_frames):
        sel = (frames >= lo) & (frames < lo + window_frames)
        before = (ing.stats.n_cnn_invocations, ing.stats.n_pixel_dedup,
                  ing.stats.n_gate_skipped, ing.stats.n_sampled_out)
        ing.feed(crops[sel], frames[sel])
        ing.flush()
        # recall probe vs ungated ingest, over everything fed so far
        got = frames_by_class(ing.index)
        hits = sum(len(got[c] & ref[c]) for c in range(n_classes))
        denom = sum(len({f for f in ref[c] if f < lo + window_frames})
                    for c in range(n_classes))
        recall = hits / denom if denom else 1.0
        ingested = ing.stats.n_cnn_invocations - before[0]
        # content redundancy only: gate + tracker skips among the objects
        # that survived the stride; the stride's own drops go in
        # separately (n_sampled_out), never as a control input
        # (AdaptiveSampler.observe)
        skipped = (ing.stats.n_pixel_dedup + ing.stats.n_gate_skipped
                   - before[1] - before[2])
        sampled_out = ing.stats.n_sampled_out - before[3]
        stride = sampler.observe(ingested, skipped, recall=recall,
                                 n_sampled_out=sampled_out)
        ing.set_frame_stride(stride)
        steps.append({"window_lo": lo, "stride": stride,
                      "ingested": int(ingested), "skipped": int(skipped),
                      "sampled_out": int(sampled_out),
                      "recall": round(recall, 4)})
    idx, stats = ing.finish()
    return {
        "mode": "gate_tune",
        "n_objects": int(stats.n_objects),
        "n_cnn_invocations": int(stats.n_cnn_invocations),
        "n_pixel_dedup": int(stats.n_pixel_dedup),
        "n_gate_skipped": int(stats.n_gate_skipped),
        "n_sampled_out": int(stats.n_sampled_out),
        "final_stride": sampler.stride,
        "steps": steps,
        "ok": True,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, help="arch:shape")
    ap.add_argument("--set", nargs="*", default=[], dest="overrides")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--gate", action="store_true",
                    help="tune the ingest redundancy gate / frame stride "
                         "with the AdaptiveSampler instead of re-tracing "
                         "a model cell")
    ap.add_argument("--device", default="cuda",
                    help="--gate's device: cuda (the kernels) or cpu")
    ap.add_argument("--tag", default="exp")
    ap.add_argument("--out", default="experiments/torch_hillclimb")
    args = ap.parse_args(argv)

    if args.gate:
        rec = gate_tune(device=args.device)
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"gate_{args.tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        last = rec["steps"][-1] if rec["steps"] else {}
        print(f"gate tune: objects={rec['n_objects']} "
              f"cnn={rec['n_cnn_invocations']} "
              f"gate_skipped={rec['n_gate_skipped']} "
              f"sampled_out={rec['n_sampled_out']} "
              f"final_stride={rec['final_stride']} "
              f"last_recall={last.get('recall')}")
        print(f"wrote {path}")
        return 0
    if args.cell is None:
        ap.error("--cell is required unless --gate is given")

    import torch.distributed as dist

    from repro_torch.launch.dryrun import run_cell

    arch, cell = args.cell.split(":")
    overrides = dict(parse_override(kv) for kv in args.overrides) or None
    try:
        rec = run_cell(arch, cell, args.multi_pod, variant=args.variant,
                       cfg_overrides=overrides)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{arch}_{cell}_{args.tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)

    if rec.get("ok") and not rec.get("skipped"):
        r = rec["roofline"]
        m = rec["memory"]
        print(f"cell={args.cell} overrides={overrides}")
        print(f"  compute={r['compute_s']:.3f}s memory={r['memory_s']:.3f}s "
              f"collective={r['collective_s']:.3f}s dom={r['dominant']}")
        print(f"  bound_step={r['bound_step_s']:.3f}s "
              f"roofline_frac={rec['roofline_fraction']:.4f} "
              f"useful={rec['useful_flops_ratio']:.3f}")
        print(f"  mem={m['live_bytes_per_device']/1e9:.2f}GB "
              f"fits={m['fits_80gb_hbm']} trace={rec['compile_s']}s")
        print("  wire: " + ", ".join(
            f"{k}={v/1e9:.1f}GB"
            for k, v in rec["collectives"]["wire_bytes"].items() if v))
    else:
        print(json.dumps(rec, indent=1)[:2000])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
