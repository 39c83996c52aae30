"""Import hygiene: the port and chip_smoke.py never import JAX or the JAX
package (precond_tpu_torch itself excepted)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "precond_tpu_torch")):
        out += [os.path.join(base, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "precond_tpu")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and _forbidden(str(arg.value)):
                bad.append(arg.value)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_sources_found():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    assert "chip_smoke.py" in names and os.path.join("precond_tpu_torch", "solver.py") in names
    for mod in ("reference_api.py", "models/collision.py", "models/hashgrid.py",
                "ops/contact.py", "ops/stencils.py", "utils/scatter.py"):
        assert os.path.join("precond_tpu_torch", *mod.split("/")) in names, mod
