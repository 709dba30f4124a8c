"""Rules ``kernel-oracle`` / ``kernel-wrapper`` / ``kernel-test`` /
``kernel-exact`` / ``kernel-outside-ops`` / ``kernel-device``: the port's
kernel contract.

The entries are the ``extern "C"`` symbols named ``*_launch`` in
``hopper/csrc/*.cu`` (read with a regex) and the ``*_launch`` rows of
``hopper/build.py``'s ``_SIGNATURES``. A wrapper of an entry is a public
function of ``hopper/ops.py`` that calls ``build.load().<entry>(...)``,
directly or through private helpers of that module. Then:

* every entry is bound (in both places) and reached by a wrapper
  (``kernel-wrapper``);
* every wrapper ``w`` has a plain version ``w_ref`` in ``hopper/ref.py``
  (``kernel-oracle``), and its body or its helpers count
  ``LAUNCHES[...]`` and tell a meta tensor from the card's (a
  ``.type == "meta"`` test, or a launch only under ``.type == "cuda"``:
  the dry run's shape propagation, ROADMAP C21) (``kernel-wrapper``);
* a function of ``tests/test_torch_hopper.py`` calls ``ops.w`` beside a
  ``repro.kernels`` function (``kernel-test``);
* a ``cuda``-marked test of ``tests/test_torch_hopper_cuda.py`` calls
  ``ops.w`` and ``ref.w_ref`` and compares them exactly
  (``assert_array_equal`` or ``torch.equal``) (``kernel-exact``).

A test "calls ``ops.w``" when it calls ``w`` or another ``ops`` function
that reaches it, itself or through the file's own helpers. A launch on
the loaded library outside ``hopper/ops.py`` is ``kernel-outside-ops``:
it bypasses the wrappers' checks and launch counts. A launch in
``hopper/ops.py`` that does not lie, in its source, inside a ``with`` of
the module's device guard (a function of the module that returns
``torch.cuda.device(...)``, or that call itself) is ``kernel-device``:
the CUDA runtime launches on the current device, so a launch on another
card's tensors would meet that card's stream from the wrong device. No
machine of the project's runs two cards, so this rule is what holds it.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import call_name, dotted
from repro_torch.analysis.callgraph import FuncInfo, ModuleInfo, ProjectIndex
from repro_torch.analysis.report import Finding

_EXTERN = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+_launch)\s*\(')
_EXACT = {"assert_array_equal", "equal"}


def _mk(path: str, line: int, rule: str, msg: str,
        def_lines=()) -> Finding:
    f = Finding(rule=rule, path=path, line=line, message=msg)
    f._def_lines = tuple(def_lines)
    return f


def _find(project: ProjectIndex, *tail: str) -> Optional[ModuleInfo]:
    for mod in project.modules.values():
        if mod.endswith(*tail):
            return mod
    return None


def _externs(csrc: str) -> Dict[str, Tuple[str, int]]:
    """{entry: (path, line)} of the ``extern "C"`` launches in csrc."""
    out: Dict[str, Tuple[str, int]] = {}
    if not os.path.isdir(csrc):
        return out
    for name in sorted(os.listdir(csrc)):
        if not name.endswith(".cu"):
            continue
        path = os.path.join(csrc, name)
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
        for m in _EXTERN.finditer(text):
            out.setdefault(m.group(1), (path, text.count("\n", 0,
                                                         m.start()) + 1))
    return out


def _signatures(build: Optional[ModuleInfo]) -> Dict[str, int]:
    """{entry: line} of the ``*_launch`` keys of ``_SIGNATURES``."""
    out: Dict[str, int] = {}
    if build is None:
        return out
    for stmt in build.tree.body:
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_SIGNATURES"
                for t in stmt.targets) and isinstance(stmt.value, ast.Dict):
            for k in stmt.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                        and k.value.endswith("_launch"):
                    out[k.value] = k.lineno
    return out


def _reach(project: ProjectIndex, fi: FuncInfo, ops: ModuleInfo,
           private_only: bool) -> Set[str]:
    """Qualnames of ops functions ``fi`` reaches (itself included),
    through private helpers only or through any ops function."""
    seen = {fi.qualname}
    frontier = [fi]
    while frontier:
        f = frontier.pop()
        for q in f.callees:
            g = project.funcs.get(q)
            if g is None or g.module is not ops or q in seen or \
                    g.class_name or g.parent:
                continue
            if private_only and not g.name.startswith("_"):
                continue
            seen.add(q)
            frontier.append(g)
    return seen


def _wrappers(project: ProjectIndex, ops: ModuleInfo):
    """{wrapper FuncInfo: entries it launches} for the public top-level
    functions of ops.py, and the functions of its reach."""
    out = {}
    for fi in ops.functions.values():
        if fi.class_name or fi.parent or fi.name.startswith("_"):
            continue
        reach = [project.funcs[q] for q in _reach(project, fi, ops, True)]
        entries = {c.func.attr for g in reach for c in g.launches}
        if entries:
            out[fi.qualname] = (fi, entries, reach)
    return out


def _is_cuda_device(call: ast.AST) -> bool:
    return isinstance(call, ast.Call) and \
        dotted(call.func) == ("torch", "cuda", "device")


def _device_guards(ops: ModuleInfo) -> Set[str]:
    """Names of the top-level functions of ops.py that return
    ``torch.cuda.device(...)``: the module's device guards."""
    out = set()
    for stmt in ops.tree.body:
        if isinstance(stmt, ast.FunctionDef) and any(
                isinstance(n, ast.Return) and _is_cuda_device(n.value)
                for n in ast.walk(stmt)):
            out.add(stmt.name)
    return out


def _unguarded_launches(fi: FuncInfo, guards: Set[str]) -> List[ast.Call]:
    """The launches of ``fi`` that lie inside no ``with`` of a guard."""
    def is_guard(expr):
        return _is_cuda_device(expr) or (
            isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
            and expr.func.id in guards)

    inside: Set[int] = set()
    for node in ast.walk(fi.node):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                is_guard(item.context_expr) for item in node.items):
            for stmt in node.body:
                inside.update(id(n) for n in ast.walk(stmt))
    return [c for c in fi.launches if id(c) not in inside]


def _counts_launches(reach: List[FuncInfo]) -> bool:
    for g in reach:
        for node in g.nodes:
            if isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Subscript) and \
                    isinstance(node.target.value, ast.Name) and \
                    node.target.value.id == "LAUNCHES":
                return True
    return False


def _tells_meta(reach: List[FuncInfo]) -> bool:
    for g in reach:
        for node in g.nodes:
            if not isinstance(node, ast.Compare):
                continue
            sides = [node.left] + list(node.comparators)
            typ = any(isinstance(s, ast.Attribute) and s.attr == "type"
                      for s in sides)
            consts = {s.value for s in sides if isinstance(s, ast.Constant)}
            for s in sides:
                if isinstance(s, (ast.Tuple, ast.List, ast.Set)):
                    consts |= {e.value for e in s.elts
                               if isinstance(e, ast.Constant)}
            if typ and consts & {"meta", "cuda"}:
                return True
    return False


def check_project(project: ProjectIndex) -> List[Finding]:
    out: List[Finding] = []
    ops = _find(project, "hopper", "ops.py")
    ref = _find(project, "hopper", "ref.py")
    build = _find(project, "hopper", "build.py")

    # launches outside hopper/ops.py
    for fi in project.funcs.values():
        if fi.module is ops:
            continue
        for call in fi.launches:
            out.append(_mk(fi.module.path, call.lineno, "kernel-outside-ops",
                           f"kernel launch '{call.func.attr}' in "
                           f"'{fi.name}' outside hopper/ops.py -- route it "
                           f"through an ops wrapper (its checks, its "
                           f"launch count)", fi.def_lines))
    if ops is None:
        return out

    guards = _device_guards(ops)
    for fi in ops.functions.values():
        for call in _unguarded_launches(fi, guards):
            out.append(_mk(ops.path, call.lineno, "kernel-device",
                           f"kernel launch '{call.func.attr}' in "
                           f"'{fi.name}' outside a device guard -- enter "
                           f"'with _on(<its tensors' device>):' around it: "
                           f"the runtime launches on the current device, "
                           f"not the tensors'", fi.def_lines))

    wrappers = _wrappers(project, ops)
    reached = set().union(*[e for _, e, _ in wrappers.values()]) \
        if wrappers else set()
    anchor = build or ops
    csrc = os.path.join(os.path.dirname(anchor.path), "csrc")
    externs = _externs(csrc)
    sigs = _signatures(build)
    for entry in sorted(set(externs) | set(sigs)):
        where = ((build.path, sigs[entry]) if entry in sigs
                 else externs[entry])
        if entry not in externs:
            out.append(_mk(*where, "kernel-wrapper",
                           f"'{entry}' is bound in _SIGNATURES but no "
                           f"extern \"C\" in hopper/csrc defines it"))
        if build is not None and entry not in sigs:
            out.append(_mk(*where, "kernel-wrapper",
                           f"extern \"C\" '{entry}' is not bound in "
                           f"hopper/build.py's _SIGNATURES"))
        if entry not in reached:
            out.append(_mk(*where, "kernel-wrapper",
                           f"kernel entry '{entry}' is reached by no "
                           f"hopper/ops.py wrapper"))

    test = _find(project, "tests", "test_torch_hopper.py")
    cuda = _find(project, "tests", "test_torch_hopper_cuda.py")
    vs_jax = _scan_tests(project, test, ops, ref, cuda_only=False)
    exact = _scan_tests(project, cuda, ops, ref, cuda_only=True)
    for fi, entries, reach in sorted(wrappers.values(),
                                     key=lambda v: v[0].node.lineno):
        w, line, dl = fi.name, fi.node.lineno, fi.def_lines
        for entry in sorted(entries - set(externs) - set(sigs)):
            out.append(_mk(ops.path, line, "kernel-wrapper",
                           f"kernel wrapper '{w}' launches '{entry}', which "
                           f"no extern \"C\" in hopper/csrc defines and "
                           f"_SIGNATURES does not bind", dl))
        if ref is None or f"{w}_ref" not in ref.symbols:
            out.append(_mk(ops.path, line, "kernel-oracle",
                           f"kernel wrapper '{w}' has no plain version "
                           f"'{w}_ref' in hopper/ref.py", dl))
        if not _counts_launches(reach):
            out.append(_mk(ops.path, line, "kernel-wrapper",
                           f"kernel wrapper '{w}' does not count its "
                           f"launches in LAUNCHES", dl))
        if not _tells_meta(reach):
            out.append(_mk(ops.path, line, "kernel-wrapper",
                           f"kernel wrapper '{w}' does not tell a meta "
                           f"tensor from the card's before it launches", dl))
        if w not in vs_jax:
            out.append(_mk(ops.path, line, "kernel-test",
                           f"tests/test_torch_hopper.py never calls ops.{w} "
                           f"beside a repro.kernels function", dl))
        if w not in exact:
            out.append(_mk(ops.path, line, "kernel-exact",
                           f"no cuda test in tests/test_torch_hopper_cuda.py "
                           f"compares ops.{w} with ref.{w}_ref exactly "
                           f"(assert_array_equal or torch.equal)", dl))
    return out


def _marked_cuda(mod: ModuleInfo, fi: FuncInfo) -> bool:
    def is_cuda(node):
        c = dotted(node.func if isinstance(node, ast.Call) else node)
        return bool(c) and c[-2:] == ("mark", "cuda")

    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "pytestmark"
                for t in stmt.targets):
            marks = (stmt.value.elts if isinstance(stmt.value,
                                                   (ast.List, ast.Tuple))
                     else [stmt.value])
            if any(is_cuda(m) for m in marks):
                return True
    return any(is_cuda(d) for d in fi.node.decorator_list)


def _scan_tests(project: ProjectIndex, test: Optional[ModuleInfo],
                ops: ModuleInfo, ref: Optional[ModuleInfo],
                cuda_only: bool) -> Set[str]:
    """The wrappers a test function holds: beside a ``repro.kernels``
    function (``cuda_only`` False), or beside their plain version with
    an exact comparison in a ``cuda``-marked test (``cuda_only``)."""
    held: Set[str] = set()
    if test is None:
        return held
    ops_reach = {q: {project.funcs[r].name
                     for r in _reach(project, fi, ops, False)}
                 for q, fi in ops.functions.items()
                 if not (fi.class_name or fi.parent)}
    ref_names = {q: fi.name for q, fi in (ref.functions.items() if ref
                                          else ())}
    local = {q: fi for q, fi in test.functions.items()}

    def facts(fi: FuncInfo):
        """(ops names reached, ref names called, a repro.kernels call, an
        exact comparison) over fi and the file's helpers it calls."""
        seen, todo = {fi.qualname}, [fi]
        o, r, jax_call, exact = set(), set(), False, False
        while todo:
            f = todo.pop()
            for node in f.nodes:
                if not isinstance(node, ast.Call):
                    continue
                chain = call_name(node)
                if chain and chain[-1] in _EXACT and (
                        chain[-1] == "assert_array_equal"
                        or chain[:-1] == ("torch",)):
                    exact = True
                canon = project.canonical(test, chain) if chain else None
                if canon and canon.startswith("repro.kernels."):
                    jax_call = True
                for q in project.call_targets(f, node):
                    if q in ops_reach:
                        o |= ops_reach[q]
                    if q in ref_names:
                        r.add(ref_names[q])
                    if q in local and q not in seen:
                        seen.add(q)
                        todo.append(local[q])
        return o, r, jax_call, exact

    for fi in test.functions.values():
        if fi.class_name or fi.parent:
            continue
        if cuda_only and not (fi.name.startswith("test")
                              and _marked_cuda(test, fi)):
            continue
        o, r, jax_call, exact = facts(fi)
        if cuda_only:
            held |= {w for w in o if f"{w}_ref" in r and exact}
        elif jax_call:
            held |= o
    return held
