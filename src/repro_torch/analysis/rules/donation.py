"""Rule ``donated-read``: a built step updates the arguments its
``StepSpec.donate_argnums`` names in place (a train step's parameters and
optimizer state, a decode step's cache), so any read of such an argument
after the step's call in the same function sees the new value where the
code expects the old one. Flagged unless the name was reassigned between
the call and the read.

For calls inside a loop, a read of the donated chain anywhere in the loop
body with no reassignment in that body is flagged too (the second
iteration reads the updated value), as the JAX package's rule does.

Tracked calls: ``NAME.fn(...)`` through a NAME bound in the same function
to a ``StepSpec(...)`` / ``_spec(...)`` call whose donate tuple is a
literal.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import Chain, assign_target_chains, dotted
from repro_torch.analysis.callgraph import FuncInfo, ModuleInfo, ProjectIndex
from repro_torch.analysis.report import Finding

_ASSIGNS = (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.For)


def _compatible(a: Chain, b: Chain) -> bool:
    """A store to ``a`` kills tracking of ``b`` when either is a prefix
    of the other."""
    n = min(len(a), len(b))
    return a[:n] == b[:n]


def _parents(root: ast.AST) -> Dict[int, ast.AST]:
    par: Dict[int, ast.AST] = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            par[id(child)] = node
    return par


def check_module(project: ProjectIndex, mod: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    for fi in mod.functions.values():
        if fi.step_sites:
            out.extend(_check_func(fi))
    return out


def _check_func(fi: FuncInfo) -> List[Finding]:
    out: List[Finding] = []
    parents = _parents(fi.node)
    stores: List[Tuple[int, Chain]] = []
    for stmt in fi.nodes:
        if isinstance(stmt, _ASSIGNS):
            for c in assign_target_chains(stmt):
                stores.append((stmt.lineno, c))

    for call, donate in fi.step_sites:
        donated: List[Chain] = []
        for i in sorted(donate):
            if i < len(call.args):
                c = dotted(call.args[i])
                if c:
                    donated.append(c)
        if not donated:
            continue
        call_nodes = {id(n) for n in ast.walk(call)}
        call_line = getattr(call, "end_lineno", call.lineno) or call.lineno
        loop = _enclosing_loop(parents, call)
        reported: Set[Tuple[Chain, int]] = set()

        def flag(chain: Chain, node: ast.AST, why: str):
            key = (chain, node.lineno)
            if key in reported:
                return
            reported.add(key)
            f = Finding(
                rule="donated-read", path=fi.module.path, line=node.lineno,
                col=getattr(node, "col_offset", 0),
                message=f"read of '{'.'.join(chain)}' {why} it was donated "
                        f"to a built step (line {call.lineno}), which "
                        f"updated it in place: this reads the new value")
            f._def_lines = fi.def_lines
            out.append(f)

        for node in fi.nodes:
            if id(node) in call_nodes:
                continue
            if not isinstance(node, (ast.Name, ast.Attribute)) or \
                    not isinstance(getattr(node, "ctx", None), ast.Load):
                continue
            chain = dotted(node)
            if chain is None:
                continue
            for d in donated:
                if chain[:len(d)] != d:
                    continue
                if node.lineno > call_line:
                    killed = any(call.lineno <= sl <= node.lineno
                                 and _compatible(sc, d) for sl, sc in stores)
                    if not killed:
                        flag(d, node, "after")
                elif loop is not None and _inside(parents, node, loop):
                    killed = any(_inside_line_range(loop, sl)
                                 and _compatible(sc, d) for sl, sc in stores)
                    if not killed:
                        flag(d, node, "on the next loop iteration after")
    return out


def _enclosing_loop(parents: Dict[int, ast.AST],
                    node: ast.AST) -> Optional[ast.AST]:
    cur = parents.get(id(node))
    while cur is not None:
        if isinstance(cur, (ast.For, ast.While)):
            return cur
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return None
        cur = parents.get(id(cur))
    return None


def _inside(parents: Dict[int, ast.AST], node: ast.AST,
            ancestor: ast.AST) -> bool:
    cur: Optional[ast.AST] = node
    while cur is not None:
        if cur is ancestor:
            return True
        cur = parents.get(id(cur))
    return False


def _inside_line_range(loop: ast.AST, line: int) -> bool:
    end = getattr(loop, "end_lineno", None)
    return end is not None and loop.lineno <= line <= end
