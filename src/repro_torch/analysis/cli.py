"""``python -m repro_torch.analysis`` — the port's focuslint CLI."""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.analysis.rules import RULES
from repro_torch.analysis.runner import run_analysis

DEFAULT_PATHS = ["src/repro_torch", "chip_smoke.py", "tests"]

_EPILOG = """\
rules:
""" + "\n".join(f"  {rid:<24}{desc.splitlines()[0]}"
                for rid, desc in sorted(RULES.items())) + """

suppressing a finding (the JAX package's syntax: one comment serves
both linters):
  append (or put on the line above, or on the enclosing def line):
      # focuslint: disable=<rule>[,<rule>] -- <one-line justification>
  whole-file scope:
      # focuslint: disable-file=<rule> -- <justification>
  a suppression without the '-- justification' is itself a finding
  (bare-suppression): the recorded reason is the point.

exit status: 0 clean, 1 unsuppressed findings, 2 usage error.

Run from the repository's root:
  PYTHONPATH=src python -m repro_torch.analysis
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="focuslint for the PyTorch/CUDA port: static checks "
                    "of its hot paths (host syncs in built steps and "
                    "kernel dispatchers, reads of donated step arguments, "
                    "the Hopper kernel contract, cache-version "
                    "discipline). AST-only: nothing is imported or run.",
        epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                   help="files or directories to scan (default: "
                        + " ".join(DEFAULT_PATHS) + ")")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="report format (default: text)")
    p.add_argument("--select", metavar="RULES",
                   help="comma-separated rule ids to report (default: all)")
    p.add_argument("--show-suppressed", action="store_true",
                   help="include suppressed findings in the report")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    p.add_argument("-o", "--output", metavar="FILE",
                   help="write the report to FILE instead of stdout")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rid, desc in sorted(RULES.items()):
            print(f"{rid:<24}{desc}")
        return 0
    select = None
    if args.select:
        select = [r.strip() for r in args.select.split(",") if r.strip()]
        unknown = [r for r in select if r not in RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(see --list-rules)", file=sys.stderr)
            return 2
    report = run_analysis(args.paths, select=select)
    text = (report.to_json(args.show_suppressed) if args.format == "json"
            else report.to_text(args.show_suppressed))
    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    else:
        print(text)
    return 1 if report.active else 0
