"""Rule ``host-sync``: a host/device sync on the port's hot paths.

Two function populations, computed by the call-graph walk:

* STEP functions (reachable from a built step's ``fn``, the function
  handed to ``StepSpec(...)`` / ``_spec(...)`` in ``launch/steps.py``):
  any ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
  ``torch.cuda.synchronize()`` is flagged, and so is ``int()`` /
  ``float()`` / ``bool()`` of a tensor (a value tracked as one, or a
  parameter annotated ``torch.Tensor``): each stalls the step until the
  card catches up, every step;
* DISPATCHERS (the host's hot path: they reach a Hopper kernel launch,
  directly or through others) -- ``.item()``, ``.tolist()``,
  ``torch.cuda.synchronize()`` and ``<event or stream>.synchronize()``
  are flagged unconditionally (each one stalls the card's queue);
  ``int()`` / ``float()`` / ``bool()`` / ``np.asarray`` / ``.cpu()`` /
  ``.numpy()`` only when applied to a value tracked as a device tensor
  (a kernel wrapper's result, a factory given a ``device``, a function
  that returns one, propagated through local assignments; what a
  ``.synchronize()`` waited for counts as landed).

Dispatchers also take in the functions that apply a callable they were
handed to a device tensor (a model's ``forward``, which the call graph
cannot follow) and the methods a dispatcher calls on its own object (the
same dispatch loop): the port's eager device work that reaches no kernel
is on the hot path all the same.

The JAX package's ``retrace-hazard`` has no counterpart: the port has no
JIT and no trace cache, and no path uses ``torch.compile`` or a CUDA
graph. Test files are skipped: tests sync on purpose to assert values.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.astutil import Chain, assign_target_chains, call_name
from repro_torch.analysis.callgraph import FuncInfo, ModuleInfo, ProjectIndex
from repro_torch.analysis.report import Finding

_SCALARS = {"builtins.int", "builtins.float", "builtins.bool"}
_NP_CASTS = {"numpy.asarray", "numpy.array"}
_FETCHES = {"item", "tolist"}
_COPIES = {"cpu", "numpy"}


def _mk(fi: FuncInfo, node: ast.AST, msg: str) -> Finding:
    f = Finding(rule="host-sync", path=fi.module.path, line=node.lineno,
                col=getattr(node, "col_offset", 0), message=msg)
    f._def_lines = fi.def_lines
    return f


def check_module(project: ProjectIndex, mod: ModuleInfo) -> List[Finding]:
    if mod.in_tests:
        return []
    out: List[Finding] = []
    seen: Set[Tuple[int, int]] = set()

    def emit(fi, node, msg):
        key = (node.lineno, getattr(node, "col_offset", 0))
        if key not in seen:
            seen.add(key)
            out.append(_mk(fi, node, msg))

    for fi in mod.functions.values():
        if fi.qualname in project.step_funcs:
            _check(project, fi, emit, step=True)
        elif fi.qualname in project.dispatchers:
            _check(project, fi, emit, step=False)
    return out


def _check(project: ProjectIndex, fi: FuncInfo, emit, step: bool):
    """One pass over the function in source order, tracking the local
    chains that hold device tensors."""
    tainted: Set[Chain] = ({(p,) for p in fi.tensor_params()} if step
                           else set())
    name = fi.name
    where = (f"built-step function '{name}'" if step
             else f"hot-path function '{name}'")

    def is_tensor(expr: ast.AST) -> bool:
        return project.expr_tainted(fi, expr, tainted)

    def visit_expr(expr: Optional[ast.AST]):
        if expr is None:
            return
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            attr = f.attr if isinstance(f, ast.Attribute) else None
            if attr in _FETCHES:
                emit(fi, node, f".{attr}() in {where} -- blocks until the "
                               f"card's result lands")
                continue
            if attr in _COPIES and (step or is_tensor(f.value)):
                emit(fi, node, f".{attr}() of a device tensor in {where} "
                               f"-- a blocking copy to the host")
                continue
            chain = call_name(node)
            canon = project.canonical(fi.module, chain) if chain else None
            if canon == "torch.cuda.synchronize" or (
                    attr == "synchronize" and not step):
                emit(fi, node, f"{'.'.join(chain or ('synchronize',))}() "
                               f"in {where} -- waits for the card")
            elif canon in _NP_CASTS and not step and node.args and \
                    is_tensor(node.args[0]):
                emit(fi, node, f"{'.'.join(chain)} of a device tensor in "
                               f"{where} -- an implicit blocking transfer")
            elif canon in _SCALARS and node.args and is_tensor(node.args[0]):
                emit(fi, node, f"{chain[0]}() of a device tensor in {where} "
                               f"-- an implicit blocking transfer")

    def visit_block(stmts):
        for stmt in stmts:
            visit_stmt(stmt)

    def visit_stmt(stmt: ast.AST):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                      # nested defs are their own FuncInfo
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            if stmt.value is not None:
                visit_expr(stmt.value)
                vt = is_tensor(stmt.value)
                for c in assign_target_chains(stmt):
                    if vt:
                        tainted.add(c)
                    elif not isinstance(stmt, ast.AugAssign):
                        for t in list(tainted):
                            if t[:len(c)] == c:
                                tainted.discard(t)
            return
        if isinstance(stmt, ast.For):
            visit_expr(stmt.iter)
            if is_tensor(stmt.iter):
                tainted.update(assign_target_chains(stmt))
            visit_block(stmt.body)
            visit_block(stmt.orelse)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            visit_expr(stmt.test)
            visit_block(stmt.body)
            visit_block(stmt.orelse)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                visit_expr(item.context_expr)
            visit_block(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            visit_block(stmt.body)
            for h in stmt.handlers:
                visit_block(h.body)
            visit_block(stmt.orelse)
            visit_block(stmt.finalbody)
            return
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.expr):
                visit_expr(sub)
        if isinstance(stmt, ast.Expr):
            landed(stmt.value)

    def landed(expr: ast.AST):
        """After ``<owner>.<event>.synchronize()`` the owner's queued
        results have landed, after ``torch.cuda.synchronize()`` all have:
        reading them is no further sync."""
        if not (isinstance(expr, ast.Call) and
                isinstance(expr.func, ast.Attribute) and
                expr.func.attr == "synchronize"):
            return
        chain = call_name(expr)
        if chain and project.canonical(fi.module, chain) == \
                "torch.cuda.synchronize":
            tainted.clear()
        elif chain and len(chain) >= 2:
            owner = chain[:max(1, len(chain) - 2)]
            for t in list(tainted):
                if t[:len(owner)] == owner:
                    tainted.discard(t)

    visit_block(fi.node.body)
