"""Project-wide symbol and call-graph index for the port's focuslint rules.

Pure AST: nothing is imported or executed. The index answers what the
rules need:

* what a ``Call`` resolves to: project functions (through module
  aliases, ``from`` imports, nested defs, ``self.`` methods and
  attributes, factories that return a function, ``functools.partial``,
  ``Cls.apply`` of an autograd Function), a launch of a Hopper kernel
  (``build.load().<entry>_launch(...)``, or through a name bound to
  ``build.load()``), or an extern such as ``torch.cuda.synchronize``;
* which functions run inside a built step (STEP functions: reachable
  from the ``fn`` handed to ``StepSpec(...)`` / ``_spec(...)``, and from
  the callables handed to the factory that made it) and which are
  DISPATCHERS (the host's hot path outside a step: they reach a kernel
  launch, directly or through others, or apply a callable they were
  handed to a device tensor; with the methods they call on their own
  object);
* which values are device tensors: what a kernel wrapper returns, a
  torch factory given a ``device``, ``.cuda()`` / ``.to(<device>)``, a
  project function that returns one, and whatever is computed from them
  (propagated through local assignments), so that host coercions of
  them can be flagged without drowning in false positives.

Inside a step, a function handed to another as an argument counts as
run by the step (``checkpoint(layer, ...)``, ``tree_map(fn, ...)``); a
function that hands one on is not thereby a dispatcher. Resolution is
deliberately shallow: anything unresolved is simply not flagged.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.astutil import (Chain, assign_target_chains,
                                          call_name, const_int_set, dotted,
                                          loads_in)

HOST_COERCIONS = {"builtins.int", "builtins.float", "builtins.bool",
                  "builtins.len", "numpy.asarray", "numpy.array"}
PARTIAL_EXTERNS = {"functools.partial", "partial"}

# Method calls whose results are host data even when the receiver is a
# device tensor: the fetches themselves (their result has landed) and
# metadata queries.
HOST_RESULT_ATTRS = {"item", "tolist", "cpu", "numpy", "dim", "numel",
                     "stride", "data_ptr", "is_contiguous", "element_size",
                     "untyped_storage", "synchronize", "query",
                     "elapsed_time", "record", "is_floating_point"}

# torch factories: a device tensor when given a ``device`` (other than a
# literal "cpu"); without one they make host tensors
TORCH_FACTORIES = {"tensor", "as_tensor", "zeros", "ones", "empty", "full",
                   "arange", "linspace", "rand", "randn", "randint",
                   "randperm", "eye", "empty_strided"}

# the callables that make a built step: (call name, index of ``fn``,
# index of the donated positions) when given positionally
STEP_MAKERS = {"StepSpec": (1, 3), "_spec": (2, 6)}
DONATE_KWARGS = ("donate_argnums", "donate")


@dataclass
class Value:
    """A statically resolved callable binding: project function
    qualnames (several when a name is bound in several places, or to a
    dict of functions)."""
    targets: Set[str] = field(default_factory=set)


@dataclass
class FuncInfo:
    qualname: str
    name: str
    module: "ModuleInfo"
    node: ast.AST
    class_name: Optional[str] = None
    parent: Optional[str] = None          # enclosing function qualname
    def_lines: Tuple[int, ...] = ()
    env: Dict[str, Value] = field(default_factory=dict)
    callees: Set[str] = field(default_factory=set)
    handed: Set[str] = field(default_factory=set)   # handed on, not called
    launches: List[ast.Call] = field(default_factory=list)
    # calls through a built step with a literal donate tuple
    step_sites: List[Tuple[ast.Call, Set[int]]] = field(default_factory=list)

    _nodes: Optional[List[ast.AST]] = None

    @property
    def nodes(self) -> List[ast.AST]:
        """``ast.walk`` of the def, computed once."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.node))
        return self._nodes

    @property
    def params(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs + a.args]

    def tensor_params(self) -> Set[str]:
        """Parameters annotated as tensors (``torch.Tensor``,
        ``Tensor``, or a string of either)."""
        out = set()
        a = self.node.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            ann = p.annotation
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                name = ann.value
            else:
                c = dotted(ann) if ann is not None else None
                name = ".".join(c) if c else ""
            if name in ("torch.Tensor", "Tensor"):
                out.add(p.arg)
        return out


@dataclass
class ModuleInfo:
    modname: str
    path: str
    tree: ast.Module
    source: str
    aliases: Dict[str, str] = field(default_factory=dict)       # import x as y
    from_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    symbols: Dict[str, Value] = field(default_factory=dict)
    functions: Dict[str, FuncInfo] = field(default_factory=dict)  # by qualname
    classes: Dict[str, Set[str]] = field(default_factory=dict)   # -> methods
    self_attrs: Dict[str, Dict[str, Value]] = field(default_factory=dict)

    @property
    def in_tests(self) -> bool:
        parts = self.path.replace(os.sep, "/").split("/")
        return "tests" in parts

    def endswith(self, *tail: str) -> bool:
        parts = self.path.replace(os.sep, "/").split("/")
        return tuple(parts[-len(tail):]) == tail


def modname_for(path: str) -> str:
    norm = os.path.normpath(path).replace(os.sep, "/")
    parts = [p for p in norm.split("/") if p not in (".", "")]
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class ProjectIndex:
    def __init__(self, files: Sequence[Tuple[str, str]]):
        """files: (path, source) pairs; paths are repo-relative."""
        self.modules: Dict[str, ModuleInfo] = {}
        self.funcs: Dict[str, FuncInfo] = {}
        self.parse_errors: List[Tuple[str, str]] = []
        self.step_funcs: Set[str] = set()
        self.dispatchers: Set[str] = set()
        self.device_returning: Set[str] = set()
        self._factories: Dict[str, Set[str]] = {}
        for path, source in files:
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError as e:
                self.parse_errors.append((path, str(e)))
                continue
            mod = ModuleInfo(modname=modname_for(path), path=path,
                             tree=tree, source=source)
            self.modules[mod.modname] = mod
        for mod in self.modules.values():
            self._collect_imports(mod)
            self._collect_defs(mod)
        for mod in self.modules.values():
            self._collect_module_bindings(mod)
        for _ in range(4):                      # factory/env fixpoint
            if not self._build_envs():
                break
        for mod in self.modules.values():
            self._collect_self_attrs(mod)
        self._collect_edges()
        self._compute_step_funcs()
        self._compute_device_returning()
        self._compute_dispatchers()

    # -- parsing passes --------------------------------------------------------

    def _collect_imports(self, mod: ModuleInfo):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        mod.aliases[a.asname] = a.name
                    else:
                        head = a.name.split(".")[0]
                        mod.aliases[head] = head
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                for a in node.names:
                    mod.from_imports[a.asname or a.name] = (node.module,
                                                            a.name)

    def _collect_defs(self, mod: ModuleInfo):
        def visit(node, class_name, parent, def_lines):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if class_name:
                        local = f"{class_name}.{child.name}"
                        mod.classes.setdefault(class_name, set()).add(
                            child.name)
                    elif parent:
                        local = f"{parent.split('::')[1]}.<locals>." \
                                f"{child.name}"
                    else:
                        local = child.name
                    qual = f"{mod.modname}::{local}"
                    if qual in self.funcs:          # a name defined twice
                        qual = f"{qual}@{child.lineno}"
                    fi = FuncInfo(qualname=qual, name=child.name, module=mod,
                                  node=child, class_name=class_name,
                                  parent=parent,
                                  def_lines=def_lines + (child.lineno,))
                    mod.functions[qual] = fi
                    self.funcs[qual] = fi
                    if not class_name and not parent:
                        old = mod.symbols.get(child.name)
                        mod.symbols[child.name] = Value(
                            (old.targets if old else set()) | {qual})
                    elif parent:
                        penv = self.funcs[parent].env
                        old = penv.get(child.name)
                        penv[child.name] = Value(
                            (old.targets if old else set()) | {qual})
                    visit(child, None, qual, fi.def_lines)
                elif isinstance(child, ast.ClassDef):
                    mod.classes.setdefault(child.name, set())
                    visit(child, child.name, None, def_lines)
                elif not isinstance(child, ast.Lambda):
                    visit(child, class_name, parent, def_lines)
        visit(mod.tree, None, None, ())

    # -- name resolution -------------------------------------------------------

    def canonical(self, mod: ModuleInfo, chain: Chain) -> Optional[str]:
        """Canonical dotted name of an extern chain, e.g. ('np',
        'asarray') -> 'numpy.asarray'."""
        head = chain[0]
        if head in mod.aliases:
            return ".".join((mod.aliases[head],) + chain[1:])
        if head in mod.from_imports:
            src, orig = mod.from_imports[head]
            return ".".join((src, orig) + chain[1:])
        if head in ("int", "float", "bool", "len") and len(chain) == 1:
            return f"builtins.{head}"
        return None

    def _symbol_of(self, canon: str) -> Optional[Value]:
        """A scanned module's top-level symbol or class ``apply`` from a
        canonical dotted name (``repro_torch.hopper.ops.topk``)."""
        parts = canon.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            other = self.modules.get(".".join(parts[:cut]))
            if other is None:
                continue
            rest = parts[cut:]
            if len(rest) == 1 and rest[0] in other.symbols:
                return other.symbols[rest[0]]
            if len(rest) == 2:
                return self._class_call(other, rest[0], rest[1])
            return None
        return None

    def _class_call(self, mod: ModuleInfo, cls: str,
                    attr: str) -> Optional[Value]:
        """``Cls.apply`` of an autograd Function runs its forward and
        backward; ``Cls.method`` is the method."""
        methods = mod.classes.get(cls)
        if methods is None:
            return None
        if attr == "apply":
            names = methods & {"forward", "backward"}
        else:
            names = {attr} & methods
        quals = {f"{mod.modname}::{cls}.{n}" for n in names}
        return Value(quals) if quals else None

    def resolve_value(self, mod: ModuleInfo, chain: Chain,
                      func: Optional[FuncInfo] = None) -> Optional[Value]:
        head = chain[0]
        if func is not None:
            f: Optional[FuncInfo] = func
            while f is not None:
                if len(chain) == 1 and head in f.env:
                    return f.env[head]
                f = self.funcs.get(f.parent) if f.parent else None
            cls = func.class_name
            if cls is None and func.parent:
                outer = self.funcs.get(func.parent)
                while outer is not None and outer.class_name is None \
                        and outer.parent:
                    outer = self.funcs.get(outer.parent)
                cls = outer.class_name if outer is not None else None
            if head == "self" and cls and len(chain) == 2:
                attrs = mod.self_attrs.get(cls, {})
                if chain[1] in attrs:
                    return attrs[chain[1]]
                return self._class_call(mod, cls, chain[1])
        if len(chain) == 1:
            if head in mod.symbols:
                return mod.symbols[head]
            if head in mod.from_imports:
                return self._symbol_of(".".join(mod.from_imports[head]))
            return None
        if len(chain) == 2 and head in mod.classes:
            return self._class_call(mod, head, chain[1])
        canon = self.canonical(mod, chain)
        return self._symbol_of(canon) if canon else None

    # -- bindings --------------------------------------------------------------

    def _collect_module_bindings(self, mod: ModuleInfo):
        for stmt in mod.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            names = [t.id for t in stmt.targets if isinstance(t, ast.Name)]
            if not names:
                continue
            if isinstance(stmt.value, ast.Dict):
                targets: Set[str] = set()
                for v in stmt.value.values:
                    c = dotted(v) if v is not None else None
                    val = self.resolve_value(mod, c) if c else None
                    if val is None:
                        targets = set()
                        break
                    targets |= val.targets
                if targets:
                    for n in names:
                        mod.symbols[n] = Value(targets)
                continue
            c = dotted(stmt.value)
            val = self.resolve_value(mod, c) if c else None
            if val is not None:
                for n in names:
                    mod.symbols.setdefault(n, val)

    def _build_envs(self) -> bool:
        changed = False
        for fi in self.funcs.values():
            for stmt in fi.nodes:
                if not isinstance(stmt, ast.Assign):
                    continue
                names = [t.id for t in stmt.targets
                         if isinstance(t, ast.Name)]
                if not names:
                    continue
                val = self._value_of_expr(fi.module, fi, stmt.value)
                if val is None:
                    continue
                for n in names:
                    old = fi.env.get(n)
                    if old is None or not val.targets <= old.targets:
                        fi.env[n] = Value(val.targets | (
                            old.targets if old else set()))
                        changed = True
        for fi in self.funcs.values():
            for sub in fi.nodes:
                if isinstance(sub, ast.Return) and sub.value is not None:
                    val = self._value_of_expr(fi.module, fi, sub.value)
                    if val is not None:
                        old = self._factories.get(fi.qualname, set())
                        if not val.targets <= old:
                            self._factories[fi.qualname] = old | val.targets
                            changed = True
        return changed

    def _value_of_expr(self, mod: ModuleInfo, fi: Optional[FuncInfo],
                       expr: ast.AST) -> Optional[Value]:
        """The functions an expression evaluates to: a function's name,
        ``partial(f, ...)``, or a call of a factory (its returned
        functions)."""
        if isinstance(expr, ast.Call):
            chain = call_name(expr)
            if chain is None:
                return None
            canon = self.canonical(mod, chain) or ".".join(chain)
            if canon in PARTIAL_EXTERNS and expr.args:
                return self._value_of_expr(mod, fi, expr.args[0])
            val = self.resolve_value(mod, chain, fi)
            if val is None:
                return None
            out: Set[str] = set()
            for q in val.targets:
                out |= self._factories.get(q, set())
            return Value(out) if out else None
        chain = dotted(expr)
        if chain:
            return self.resolve_value(mod, chain, fi)
        return None

    def _collect_self_attrs(self, mod: ModuleInfo):
        by_class: Dict[str, Dict[str, Value]] = {}
        for fi in mod.functions.values():
            if not fi.class_name:
                continue
            attrs = by_class.setdefault(fi.class_name, {})
            for stmt in fi.nodes:
                if not isinstance(stmt, ast.Assign):
                    continue
                for t in stmt.targets:
                    c = dotted(t)
                    if not c or len(c) != 2 or c[0] != "self":
                        continue
                    val = self._value_of_expr(mod, fi, stmt.value)
                    if val is not None:
                        old = attrs.get(c[1])
                        attrs[c[1]] = Value(val.targets | (
                            old.targets if old else set()))
        mod.self_attrs = by_class

    # -- calls -----------------------------------------------------------------

    def call_targets(self, fi: FuncInfo, call: ast.Call) -> Set[str]:
        if isinstance(call.func, ast.Call):
            val = self._value_of_expr(fi.module, fi, call.func)
            return set(val.targets) if val else set()
        chain = call_name(call)
        if chain is None:
            return set()
        val = self.resolve_value(fi.module, chain, fi)
        return set(val.targets) if val else set()

    def is_library_load(self, mod: ModuleInfo, expr: ast.AST) -> bool:
        """``build.load()``: the kernel library."""
        if not isinstance(expr, ast.Call) or expr.args:
            return False
        chain = call_name(expr)
        if chain is None or chain[-1] != "load":
            return False
        canon = self.canonical(mod, chain) or ".".join(chain)
        return canon == "build.load" or canon.endswith(".build.load")

    def is_launch(self, fi: FuncInfo, call: ast.Call) -> bool:
        """``<library>.<entry>_launch(...)``, the library being
        ``build.load()`` or a local name bound to it."""
        f = call.func
        if not isinstance(f, ast.Attribute) or not f.attr.endswith("_launch"):
            return False
        if self.is_library_load(fi.module, f.value):
            return True
        return isinstance(f.value, ast.Name) and \
            f.value.id in self._library_names(fi)

    def _library_names(self, fi: FuncInfo) -> Set[str]:
        names: Set[str] = set()
        scopes = [fi.node, fi.module.tree]
        f = fi
        while f.parent:
            f = self.funcs[f.parent]
            scopes.append(f.node)
        for scope in scopes:
            body = scope.body if isinstance(scope, ast.Module) else [scope]
            for root in body:
                for st in ast.walk(root):
                    if isinstance(st, ast.Assign) and \
                            self.is_library_load(fi.module, st.value):
                        names |= {t.id for t in st.targets
                                  if isinstance(t, ast.Name)}
        return names

    def _collect_edges(self):
        for fi in self.funcs.values():
            for node, lam in _own_calls(fi.node):
                if self.is_launch(fi, node):
                    fi.launches.append(node)
                    continue
                # a lambda's calls run where the lambda is called
                (fi.handed if lam else fi.callees).update(
                    self.call_targets(fi, node))
                # a function handed to another may be called by it
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    c = dotted(arg)
                    if c:
                        val = self.resolve_value(fi.module, c, fi)
                        if val:
                            fi.handed |= val.targets
            if fi.parent:
                # defined there; called where a call resolves to it
                parent = self.funcs.get(fi.parent)
                if parent is not None:
                    parent.handed.add(fi.qualname)
            self._collect_step_sites(fi)

    # -- built steps -----------------------------------------------------------

    def step_maker(self, fi: FuncInfo, call: ast.Call):
        """(fn expression, donated positions or None) when ``call`` makes a
        built step (``StepSpec(...)`` / ``_spec(...)``), else None."""
        chain = call_name(call)
        if chain is None or chain[-1] not in STEP_MAKERS:
            return None
        fn_pos, don_pos = STEP_MAKERS[chain[-1]]
        fn_expr = don_expr = None
        for kw in call.keywords:
            if kw.arg == "fn":
                fn_expr = kw.value
            elif kw.arg in DONATE_KWARGS:
                don_expr = kw.value
        if fn_expr is None and len(call.args) > fn_pos:
            fn_expr = call.args[fn_pos]
        if don_expr is None and len(call.args) > don_pos:
            don_expr = call.args[don_pos]
        donate = const_int_set(don_expr) if don_expr is not None else set()
        return fn_expr, donate

    def _collect_step_sites(self, fi: FuncInfo):
        """Calls ``NAME.fn(...)`` through a NAME bound in this function to
        a step made with a literal donate tuple."""
        made: Dict[str, Set[int]] = {}
        for stmt in fi.nodes:
            if isinstance(stmt, ast.Assign) and \
                    isinstance(stmt.value, ast.Call):
                got = self.step_maker(fi, stmt.value)
                if got is not None and got[1]:
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            made[t.id] = got[1]
        if not made:
            return
        for node in fi.nodes:
            if isinstance(node, ast.Call):
                chain = call_name(node)
                if chain and len(chain) == 2 and chain[1] == "fn" \
                        and chain[0] in made:
                    fi.step_sites.append((node, made[chain[0]]))

    def _root_functions(self, fi: FuncInfo, expr: ast.AST,
                        seen_names=()) -> Set[str]:
        """The functions a step's ``fn`` expression runs: what it names,
        what the factory it was made by returns, and the callables handed
        to that factory (lambdas: the functions their bodies call)."""
        out: Set[str] = set()
        if isinstance(expr, ast.Lambda):
            for sub in ast.walk(expr.body):
                if isinstance(sub, ast.Call):
                    out |= self.call_targets(fi, sub)
            return out
        if isinstance(expr, ast.Call):
            val = self._value_of_expr(fi.module, fi, expr)
            if val:
                out |= val.targets
            for arg in list(expr.args) + [k.value for k in expr.keywords]:
                if isinstance(arg, ast.Lambda):
                    out |= self._root_functions(fi, arg)
                else:
                    c = dotted(arg)
                    v = self.resolve_value(fi.module, c, fi) if c else None
                    if v:
                        out |= v.targets
            return out
        chain = dotted(expr)
        if chain is None:
            return out
        val = self.resolve_value(fi.module, chain, fi)
        if val:
            out |= val.targets
        if len(chain) == 1 and chain[0] not in seen_names:
            # a local name bound to a factory's call
            for stmt in fi.nodes:
                if isinstance(stmt, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == chain[0]
                        for t in stmt.targets) and \
                        isinstance(stmt.value, (ast.Call, ast.Lambda)):
                    out |= self._root_functions(
                        fi, stmt.value, tuple(seen_names) + (chain[0],))
        return out

    # -- closures --------------------------------------------------------------

    def _compute_step_funcs(self):
        roots: Set[str] = set()
        for fi in self.funcs.values():
            for node in fi.nodes:
                if isinstance(node, ast.Call):
                    got = self.step_maker(fi, node)
                    if got is not None and got[0] is not None:
                        roots |= self._root_functions(fi, got[0])
        step = set(roots)
        frontier = set(roots)
        while frontier:
            nxt: Set[str] = set()
            for q in frontier:
                fn = self.funcs.get(q)
                if fn is None:
                    continue
                for c in (fn.callees | fn.handed) - step:
                    step.add(c)
                    nxt.add(c)
            frontier = nxt
        self.step_funcs = step

    def _applies_handed_callable(self, fi: FuncInfo) -> bool:
        """Whether fi calls a callable it was handed (a parameter of its
        own or of an enclosing function) on a device tensor: device work
        the call graph cannot follow (``forward(x)`` of a model)."""
        handed: Set[str] = set()
        f: Optional[FuncInfo] = fi
        while f is not None:
            handed |= set(f.params) - set(f.env)
            f = self.funcs.get(f.parent) if f.parent else None
        tainted: Set[Chain] = set()
        for stmt in fi.nodes:
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                if stmt.value is not None and \
                        self.expr_tainted(fi, stmt.value, tainted):
                    tainted.update(assign_target_chains(stmt))
            if isinstance(stmt, ast.Call) and \
                    isinstance(stmt.func, ast.Name) and \
                    stmt.func.id in handed and any(
                        self.expr_tainted(fi, a, tainted)
                        for a in stmt.args):
                return True
        return False

    def _compute_dispatchers(self):
        """The host's hot path: functions that reach a kernel launch or
        apply a handed callable to a device tensor, their callers, and the
        methods they call on their own object (the same dispatch loop),
        to a fixpoint; the step functions excepted."""
        rev: Dict[str, Set[str]] = {}
        for fi in self.funcs.values():
            for c in fi.callees:
                rev.setdefault(c, set()).add(fi.qualname)
        hot = {fi.qualname for fi in self.funcs.values()
               if fi.launches or (not fi.module.in_tests
                                  and self._applies_handed_callable(fi))}
        frontier = set(hot)
        while frontier:
            nxt = set()
            for q in frontier:
                fi = self.funcs[q]
                near = set(rev.get(q, ()))
                if fi.class_name:
                    near |= {c for c in fi.callees
                             if c in self.funcs
                             and self.funcs[c].module is fi.module
                             and self.funcs[c].class_name == fi.class_name}
                for c in near - hot:
                    hot.add(c)
                    nxt.add(c)
            frontier = nxt
        self.dispatchers = hot - self.step_funcs

    # -- device tensors --------------------------------------------------------

    def call_returns_device(self, fi: FuncInfo, call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Attribute):
            if f.attr == "cuda":
                return True
            if f.attr == "to":
                return any(_names_a_device(a) for a in call.args) or any(
                    k.arg == "device" and _names_a_device(k.value)
                    for k in call.keywords)
        if self.is_launch(fi, call):
            return False                    # an error code
        targets = self.call_targets(fi, call)
        if targets:
            return bool(targets & self.device_returning)
        chain = call_name(call)
        canon = self.canonical(fi.module, chain) if chain else None
        if canon and canon.startswith("torch.") and \
                canon.split(".")[-1] in TORCH_FACTORIES and \
                canon.count(".") == 1:
            return any(k.arg == "device" and not _is_cpu(k.value)
                       for k in call.keywords)
        return False

    def expr_is_coercion(self, fi: FuncInfo, expr: ast.AST) -> bool:
        """True for calls whose result is host data even if their inputs
        are device tensors (taint stops there)."""
        if not isinstance(expr, ast.Call):
            return False
        if isinstance(expr.func, ast.Attribute) and \
                expr.func.attr in HOST_RESULT_ATTRS:
            return True
        chain = call_name(expr)
        if chain is None:
            return False
        return self.canonical(fi.module, chain) in HOST_COERCIONS

    def taint_stops(self, fi: FuncInfo, expr: ast.AST) -> Set[int]:
        """Node ids of subtrees under taint-stopping calls inside
        ``expr``: loads and device calls there do not taint the result."""
        skip: Set[int] = set()
        for sub in ast.walk(expr):
            if id(sub) in skip:
                continue
            if isinstance(sub, ast.Call) and self.expr_is_coercion(fi, sub):
                for inner in ast.walk(sub):
                    skip.add(id(inner))
        return skip

    def expr_tainted(self, fi: FuncInfo, expr: ast.AST,
                     tainted: Set[Chain]) -> bool:
        """Whether ``expr`` evaluates to a device tensor, given the local
        chains known to hold one."""
        if self.expr_is_coercion(fi, expr):
            return False
        skip = self.taint_stops(fi, expr)
        for sub in ast.walk(expr):
            if id(sub) in skip:
                continue
            if isinstance(sub, ast.Call) and \
                    self.call_returns_device(fi, sub):
                return True
        for chain, node in loads_in(expr):
            if id(node) in skip:
                continue
            for t in tainted:
                if chain[:len(t)] == t:
                    return True
        return False

    def _returns_device(self, fi: FuncInfo) -> bool:
        tainted: Set[Chain] = set()
        for stmt in fi.nodes:
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                if stmt.value is not None and \
                        self.expr_tainted(fi, stmt.value, tainted):
                    tainted.update(assign_target_chains(stmt))
        return any(isinstance(s, ast.Return) and s.value is not None
                   and self.expr_tainted(fi, s.value, tainted)
                   for s in fi.nodes)

    def _compute_device_returning(self):
        """A worklist fixpoint: a function joins when it returns a device
        tensor; then its callers are checked again. Test modules are
        left out (no rule reads their results' taint)."""
        rev: Dict[str, Set[str]] = {}
        for fi in self.funcs.values():
            for c in fi.callees:
                rev.setdefault(c, set()).add(fi.qualname)
        todo = [q for q, fi in self.funcs.items()
                if not fi.module.in_tests and any(
                    isinstance(s, ast.Return) and s.value is not None
                    for s in fi.nodes)]
        queued = set(todo)
        while todo:
            q = todo.pop()
            queued.discard(q)
            fi = self.funcs[q]
            if q in self.device_returning or not self._returns_device(fi):
                continue
            self.device_returning.add(q)
            for caller in rev.get(q, ()):
                if caller not in self.device_returning and \
                        caller not in queued and \
                        not self.funcs[caller].module.in_tests:
                    queued.add(caller)
                    todo.append(caller)

def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _names_a_device(node: ast.AST) -> bool:
    """``.to(x)`` moves to the card when x is a device string other than
    "cpu", or a name that says it holds a device (``dev``,
    ``self.device``); a dtype or a tensor is not a device."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    c = dotted(node)
    return bool(c) and ("dev" in c[-1].lower())


def _own_calls(fn: ast.AST):
    """(call, inside a lambda) for the calls in fn's own body: nested
    defs and classes are their own functions."""
    def visit(node, lam):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            if isinstance(child, ast.Call):
                yield child, lam
            yield from visit(child, lam or isinstance(child, ast.Lambda))
    yield from visit(fn, False)
