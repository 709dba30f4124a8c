"""Rule ``cache-version``: the GT-label cache is keyed on
``(cid, versions[cid])`` — any in-place mutation of a store's
``centroids`` / ``mean_probs`` / ``counts`` / ``fold_counts`` columns
that does not also bump ``versions`` in the same function serves stale
cached labels while looking functionally correct.

A function that subscript-assigns any watched column of a base object
(``self.counts[uniq] += ...``, ``s.centroids[rows] = ...``) must also
subscript- or slice-assign ``<base>.versions`` somewhere in the same
function.  Intentional exemptions (e.g. ``ClusterStore.attach``, whose
count bump is label-neutral by design) carry an inline suppression with
the rationale. The JAX package's rule, unchanged: the port's stores
(``core/index.py``) keep the same columns.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.astutil import Chain, dotted
from repro_torch.analysis.callgraph import ModuleInfo, ProjectIndex
from repro_torch.analysis.report import Finding

WATCHED = ("centroids", "mean_probs", "counts", "fold_counts")


def check_module(project: ProjectIndex, mod: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    for fi in mod.functions.values():
        stores: Dict[Chain, List[Tuple[int, str]]] = {}
        version_bases: Set[Chain] = set()
        for stmt in fi.nodes:
            if isinstance(stmt, (ast.Assign, ast.AugAssign)):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    if not isinstance(t, ast.Subscript):
                        continue
                    chain = dotted(t.value)
                    if chain is None or len(chain) < 2:
                        continue
                    if chain[-1] in WATCHED:
                        stores.setdefault(chain[:-1], []).append(
                            (stmt.lineno, chain[-1]))
                    elif chain[-1] == "versions":
                        version_bases.add(chain[:-1])
        for base, hits in stores.items():
            if base in version_bases:
                continue
            hits.sort()
            line = hits[0][0]
            cols = ", ".join(sorted({h[1] for h in hits}))
            f = Finding(
                rule="cache-version", path=mod.path, line=line,
                message=f"'{fi.name}' mutates {'.'.join(base)}.{{{cols}}} "
                        f"in place without bumping "
                        f"{'.'.join(base)}.versions — the (cid, version) "
                        f"GT-label cache will serve stale labels")
            f._def_lines = fi.def_lines
            out.append(f)
    return out
