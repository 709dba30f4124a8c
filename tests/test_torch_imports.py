"""Import guard: the port and its chip smoke script import neither JAX nor
anything of the JAX package ``repro`` (only the tests import both)."""
import ast
import os

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO_ROOT, "src", "repro_torch")


def _files():
    out = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(tree: ast.AST):
    """(line, module) for every import statement and every
    ``importlib.import_module`` / ``__import__`` of a literal name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else getattr(fn, "id", None))
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_guard_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom repro.core import index\n"
           "import repro_torch.core\nimportlib.import_module('jax')\n")
    bad = [m for _, m in _imports(ast.parse(src)) if _forbidden(m)]
    assert bad == ["jax.numpy", "repro.core", "jax"]


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_port_imports_no_jax_and_no_repro(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [(line, m) for line, m in _imports(tree) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"
