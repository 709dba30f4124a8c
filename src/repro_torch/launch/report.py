"""Markdown tables of the dry run's per-cell records
(``repro_torch.launch.dryrun``): a port of ``repro.launch.report``.

  PYTHONPATH=src python -m repro_torch.launch.report experiments/torch_dryrun
  PYTHONPATH=src python -m repro_torch.launch.report --cells DIR   # one
      row per (arch, cell), both meshes side by side

The roofline terms are the modelled H100 cluster's (the record's
``constants``), not measurements.
"""
from __future__ import annotations

import glob
import json
import os
import sys


def load(dirpath: str):
    recs = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        tag = "multi" if (r.get("mesh", {}).get("pod") or
                          "multi" in os.path.basename(f)) else "single"
        r["mesh_tag"] = tag
        r["file"] = os.path.basename(f)
        recs.append(r)
    return recs


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    return f"{x*1e3:.1f}ms"


def dryrun_table(recs):
    print("| arch | cell | mesh | status | trace | GB/dev | fits 80GB | "
          "collectives (AG/AR/RS/A2A/CP) |")
    print("|---|---|---|---|---|---|---|---|")
    for r in recs:
        arch, cell = r.get("arch"), r.get("cell")
        tag = r["mesh_tag"]
        var = f" ({r['variant']})" if r.get("variant") else ""
        if r.get("skipped"):
            print(f"| {arch} | {cell}{var} | {tag} | SKIP (full-attn, "
                  f"see DESIGN.md) | | | | |")
            continue
        if not r.get("ok"):
            print(f"| {arch} | {cell}{var} | {tag} | **FAIL**: "
                  f"{r.get('error','')[:60]} | | | | |")
            continue
        m = r.get("memory", {})
        live = m.get("live_bytes_per_device", 0) / 1e9
        fits = "yes" if m.get("fits_80gb_hbm") else "**NO**"
        c = r.get("scanned_raw", {}).get("collective_counts", {})
        cc = (f"{c.get('all-gather',0)}/{c.get('all-reduce',0)}"
              f"/{c.get('reduce-scatter',0)}/{c.get('all-to-all',0)}"
              f"/{c.get('collective-permute',0)}")
        print(f"| {arch} | {cell}{var} | {tag} | ok | {r['compile_s']}s | "
              f"{live:.1f} | {fits} | {cc} |")


def roofline_table(recs):
    print("| arch | cell | compute | memory | collective | dominant | "
          "bound/step | MODEL_FLOPS | useful ratio | roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r["mesh_tag"] != "single" or r.get("skipped") or not r.get("ok"):
            continue
        rl = r["roofline"]
        var = f" ({r['variant']})" if r.get("variant") else ""
        print(f"| {r['arch']} | {r['cell']}{var} | {fmt_s(rl['compute_s'])} | "
              f"{fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} | "
              f"**{rl['dominant'].replace('_s','')}** | "
              f"{fmt_s(rl['bound_step_s'])} | {r['model_flops']:.3g} | "
              f"{r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} |")


def cell_table(recs):
    """One row per (arch, cell): on each mesh the dominant term, the
    bound step, the roofline fraction, GB per device and whether it fits
    80 GB (a skip or a failure in place of the numbers)."""
    print("| arch | cell | 16x16: dominant, bound, frac, GB/dev, fits | "
          "2x16x16: dominant, bound, frac, GB/dev, fits |")
    print("|---|---|---|---|")
    rows = {}
    for r in recs:
        var = f" ({r['variant']})" if r.get("variant") else ""
        rows.setdefault((r.get("arch"), f"{r.get('cell')}{var}"),
                        {})[r["mesh_tag"]] = r

    def cellf(r):
        if r is None:
            return "—"
        if r.get("skipped"):
            return "skip (full attention)"
        if not r.get("ok"):
            return f"**FAIL**: {r.get('error', '')[:40]}"
        rl, m = r["roofline"], r["memory"]
        fits = "yes" if m.get("fits_80gb_hbm") else "**NO**"
        return (f"{rl['dominant'].replace('_s', '')}, "
                f"{fmt_s(rl['bound_step_s'])}, "
                f"{r['roofline_fraction']:.3f}, "
                f"{m['live_bytes_per_device'] / 1e9:.1f}, {fits}")

    for (arch, cell), by in rows.items():
        print(f"| {arch} | {cell} | {cellf(by.get('single'))} | "
              f"{cellf(by.get('multi'))} |")


def main():
    args = [a for a in sys.argv[1:] if a != "--cells"]
    d = args[0] if args else "experiments/torch_dryrun"
    recs = load(d)
    if "--cells" in sys.argv[1:]:
        cell_table(recs)
        return
    n_ok = sum(1 for r in recs if r.get("ok"))
    n_skip = sum(1 for r in recs if r.get("skipped"))
    print(f"<!-- {len(recs)} cells: {n_ok} ok ({n_skip} documented skips), "
          f"{len(recs)-n_ok} failed -->\n")
    print("### Dry-run matrix\n")
    dryrun_table(recs)
    print("\n### Roofline (single-pod 16x16, per device; modelled H100 "
          "constants)\n")
    roofline_table(recs)


if __name__ == "__main__":
    main()
