"""File collection, rule dispatch, and suppression application."""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis import suppress
from repro_torch.analysis.callgraph import ProjectIndex
from repro_torch.analysis.report import Finding, Report
from repro_torch.analysis.rules import RULES
from repro_torch.analysis.rules import (cache_version, donation, host_sync,
                                  kernel_contract)

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules"}


def collect_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
                for n in sorted(names):
                    if n.endswith(".py"):
                        out.append(os.path.join(root, n))
    seen, uniq = set(), []
    for p in out:
        key = os.path.normpath(p)
        if key not in seen:
            seen.add(key)
            uniq.append(os.path.normpath(p))
    return uniq


def run_analysis(paths: Sequence[str],
                 select: Optional[Iterable[str]] = None) -> Report:
    files = collect_files(paths)
    sources: List[Tuple[str, str]] = []
    report = Report()
    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                sources.append((path, fh.read()))
        except OSError as e:
            report.findings.append(Finding(
                rule="parse-error", path=path, line=1,
                message=f"unreadable: {e}"))
    project = ProjectIndex(sources)
    report.n_files = len(sources)
    report.n_functions = len(project.funcs)
    for path, err in project.parse_errors:
        report.findings.append(Finding(rule="parse-error", path=path,
                                       line=1, message=err))

    findings: List[Finding] = []
    for mod in project.modules.values():
        findings.extend(host_sync.check_module(project, mod))
        findings.extend(donation.check_module(project, mod))
        findings.extend(cache_version.check_module(project, mod))
    findings.extend(kernel_contract.check_project(project))

    sups: Dict[str, suppress.FileSuppressions] = {
        path: suppress.parse_file(path, src) for path, src in sources}
    for f in findings:
        sup = sups.get(f.path)
        if sup is None:
            continue
        entry = sup.lookup(f.rule, f.line, getattr(f, "_def_lines", ()))
        if entry is not None:
            f.suppressed = True
            f.justification = entry.reason
    for sup in sups.values():
        findings.extend(sup.bare_findings())

    if select:
        wanted = set(select)
        findings = [f for f in findings if f.rule in wanted]
    # dedupe (nested walks can revisit a node)
    seen = set()
    for f in findings:
        if f.key() not in seen:
            seen.add(f.key())
            report.findings.append(f)
    report.sort()
    return report


__all__ = ["run_analysis", "collect_files", "RULES"]
