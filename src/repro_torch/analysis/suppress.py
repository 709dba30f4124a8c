"""Inline suppression comments (the JAX package's syntax, so that one
comment serves both linters).

Syntax (same line, the line above, or the enclosing ``def`` line for
function scope)::

    x = int(state.n)  # focuslint: disable=host-sync -- bound-gated, once per epoch
    # focuslint: disable=host-sync,donated-read -- staged sync boundary
    # focuslint: disable-file=cache-version -- fixture file

``disable-file`` applies to the whole module.  A ``disable`` without a
``-- justification`` is itself reported (rule ``bare-suppression``): the
point of the annotation is the recorded reason.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.report import Finding

_PAT = re.compile(
    r"#\s*focuslint:\s*(disable|disable-file)\s*=\s*"
    r"([A-Za-z0-9_,\s-]+?)"
    r"(?:\s*--\s*(.*?))?\s*$")

ALL = "all"


@dataclass
class _Entry:
    rules: Set[str]
    reason: Optional[str]
    line: int
    file_scope: bool = False


@dataclass
class FileSuppressions:
    """Parsed suppressions for one source file."""
    path: str
    by_line: Dict[int, List[_Entry]] = field(default_factory=dict)
    file_wide: List[_Entry] = field(default_factory=list)

    def lookup(self, rule: str, line: int,
               def_lines: Tuple[int, ...] = ()) -> Optional[_Entry]:
        """Match a finding at ``line`` (inside defs starting at
        ``def_lines``) against: same line, previous line, any enclosing
        def line (or its preceding line), then file-wide entries."""
        candidates = [line, line - 1]
        for d in def_lines:
            candidates += [d, d - 1]
        for ln in candidates:
            for e in self.by_line.get(ln, ()):  # pragma: no branch
                if rule in e.rules or ALL in e.rules:
                    return e
        for e in self.file_wide:
            if rule in e.rules or ALL in e.rules:
                return e
        return None

    def bare_findings(self) -> List[Finding]:
        out = []
        for entries in list(self.by_line.values()) + [self.file_wide]:
            for e in entries:
                if not e.reason:
                    out.append(Finding(
                        rule="bare-suppression", path=self.path,
                        line=e.line,
                        message="suppression without a '-- justification'; "
                                "record why the finding is intentional"))
        return out


def parse_file(path: str, source: str) -> FileSuppressions:
    sup = FileSuppressions(path=path)
    lines = source.splitlines()
    for i, text in enumerate(lines, start=1):
        if "focuslint" not in text:
            continue
        m = _PAT.search(text)
        if not m:
            continue
        kind, rules_raw, reason = m.groups()
        rules = {r.strip() for r in rules_raw.split(",") if r.strip()}
        if not rules:
            continue
        # a comment-only directive may wrap its justification over
        # following comment lines; fold those into the reason and attach
        # the entry to the next code line as well
        attach = [i]
        stripped = text.lstrip()
        if stripped.startswith("#"):
            reason_parts = [reason] if reason else []
            j = i
            while j < len(lines):
                nxt = lines[j].strip()
                if nxt.startswith("#"):
                    if reason_parts:
                        reason_parts.append(nxt.lstrip("# "))
                    j += 1
                elif not nxt:
                    j += 1
                else:
                    attach.append(j + 1)
                    break
            reason = " ".join(p for p in reason_parts if p) or reason
        entry = _Entry(rules=rules, reason=(reason or None), line=i,
                       file_scope=(kind == "disable-file"))
        if entry.file_scope:
            sup.file_wide.append(entry)
        else:
            for ln in attach:
                sup.by_line.setdefault(ln, []).append(entry)
    return sup
