"""Small AST helpers shared by the focuslint rules."""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Sequence, Set, Tuple

Chain = Tuple[str, ...]


def dotted(node: ast.AST) -> Optional[Chain]:
    """``a.b.c`` -> ('a','b','c'); None for anything not a pure
    Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[Chain]:
    return dotted(call.func)


def walk_in_order(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk but depth-first in source order (good enough for the
    linear taint pass)."""
    for child in ast.iter_child_nodes(node):
        yield child
        yield from walk_in_order(child)


def const_str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return tuple(out)
    return None


def const_int_set(node: ast.AST) -> Optional[Set[int]]:
    """Resolve a literal int / tuple-of-ints; for conditional
    expressions, the union of both branches (conservative)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List)):
        out: Set[int] = set()
        for e in node.elts:
            s = const_int_set(e)
            if s is None:
                return None
            out |= s
        return out
    if isinstance(node, ast.IfExp):
        a = const_int_set(node.body)
        b = const_int_set(node.orelse)
        if a is None and b is None:
            return None
        return (a or set()) | (b or set())
    return None


def assign_target_chains(stmt: ast.AST) -> List[Chain]:
    """All Name/Attribute chains stored to by an Assign/AugAssign/
    AnnAssign/For/With statement (tuple targets flattened; subscript
    stores report the base chain)."""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.For):
        targets = [stmt.target]
    elif isinstance(stmt, ast.withitem) and stmt.optional_vars:
        targets = [stmt.optional_vars]
    out: List[Chain] = []

    def add(t: ast.AST):
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                add(e)
        elif isinstance(t, ast.Starred):
            add(t.value)
        elif isinstance(t, ast.Subscript):
            c = dotted(t.value)
            if c:
                out.append(c)
        else:
            c = dotted(t)
            if c:
                out.append(c)

    for t in targets:
        add(t)
    return out


def chain_matches(load: Chain, tracked: Chain) -> bool:
    """True when a Load of ``load`` observes ``tracked``: equal, or
    tracked is a prefix of load (``st.centroids`` observed through
    ``st.centroids.shape`` is handled by callers' static-attr filter)."""
    return load[:len(tracked)] == tracked


STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                "is_meta", "requires_grad", "layout"}


def loads_in(node: ast.AST) -> Iterator[Tuple[Chain, ast.AST]]:
    """Yield (chain, node) for every maximal Name/Attribute Load chain
    inside ``node`` (skipping chains that are pure static metadata like
    ``x.shape``/``x.dtype``/``x.device``)."""
    seen: Set[int] = set()
    for sub in ast.walk(node):
        if id(sub) in seen:
            continue
        if isinstance(sub, (ast.Attribute, ast.Name)) and \
                isinstance(getattr(sub, "ctx", None), ast.Load):
            c = dotted(sub)
            if c is None:
                continue
            for inner in ast.walk(sub):
                seen.add(id(inner))
            if any(p in STATIC_ATTRS for p in c[1:]):
                continue
            yield c, sub


def enclosing_def_lines(func_stack: Sequence[ast.AST]) -> Tuple[int, ...]:
    return tuple(f.lineno for f in func_stack
                 if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)))
