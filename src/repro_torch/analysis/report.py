"""Finding records and text/JSON report rendering."""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import List, Optional


@dataclass
class Finding:
    """One rule violation at a source location.

    ``suppressed`` findings passed an inline ``# focuslint: disable=``
    with a justification; they are reported (under ``--show-suppressed``)
    but never fail the run.
    """
    rule: str
    path: str
    line: int
    message: str
    col: int = 0
    suppressed: bool = False
    justification: Optional[str] = None

    def key(self):
        return (self.path, self.line, self.rule, self.message)


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    n_files: int = 0
    n_functions: int = 0

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]

    def extend(self, findings):
        self.findings.extend(findings)

    def sort(self):
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))

    # -- rendering -------------------------------------------------------------

    def to_json(self, show_suppressed: bool = False) -> str:
        doc = {
            "version": 1,
            "n_files": self.n_files,
            "n_functions": self.n_functions,
            "n_findings": len(self.active),
            "n_suppressed": len(self.suppressed),
            "findings": [asdict(f) for f in self.active],
        }
        if show_suppressed:
            doc["suppressed"] = [asdict(f) for f in self.suppressed]
        return json.dumps(doc, indent=2)

    def to_text(self, show_suppressed: bool = False) -> str:
        lines = []
        for f in self.active:
            lines.append(f"{f.path}:{f.line}:{f.col}: [{f.rule}] "
                         f"{f.message}")
        if show_suppressed:
            for f in self.suppressed:
                why = f" ({f.justification})" if f.justification else ""
                lines.append(f"{f.path}:{f.line}:{f.col}: [{f.rule}] "
                             f"suppressed: {f.message}{why}")
        lines.append(
            f"focuslint: {len(self.active)} finding(s), "
            f"{len(self.suppressed)} suppressed, {self.n_files} file(s) "
            f"scanned")
        return "\n".join(lines)
