"""Import hygiene: the port, chip_smoke.py, bench_torch.py,
graft_entry_torch.py and the port's scripts (scripts/torch_*.py) never
import JAX, the JAX package (precond_tpu_torch itself excepted) or JAX's
dependencies that the card's machine lacks (ml_dtypes, orbax);
bench_torch.py and graft_entry_torch.py do not import chip_smoke.py
either."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sources():
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "bench_torch.py",
                                           "graft_entry_torch.py")]
    scripts = os.path.join(ROOT, "scripts")
    out += [os.path.join(scripts, f) for f in sorted(os.listdir(scripts))
            if f.startswith("torch_") and f.endswith(".py")]
    for base, _, files in os.walk(os.path.join(ROOT, "precond_tpu_torch")):
        out += [os.path.join(base, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str, path: str) -> bool:
    top = name.split(".")[0]
    if top == "chip_smoke":
        return os.path.basename(path) in ("bench_torch.py", "graft_entry_torch.py")
    return top in ("jax", "jaxlib", "precond_tpu", "ml_dtypes", "orbax")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name, path)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module, path):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and _forbidden(str(arg.value), path):
                bad.append(arg.value)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_sources_found():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {"chip_smoke.py", "bench_torch.py", "graft_entry_torch.py"} <= names
    assert _forbidden("chip_smoke", os.path.join(ROOT, "bench_torch.py"))
    assert _forbidden("chip_smoke", os.path.join(ROOT, "graft_entry_torch.py"))
    assert not _forbidden("chip_smoke", os.path.join(ROOT, "scripts", "x.py"))
    assert os.path.join("precond_tpu_torch", "solver.py") in names
    for script in ("torch_multiprocess_worker.py", "torch_scaling_model.py",
                   "torch_scaling_capacity.py", "torch_pod_solve.py", "torch_probe_common.py",
                   "torch_probe_stiff.py", "torch_probe_isosort.py", "torch_probe_damping.py",
                   "torch_probe_contact.py", "torch_probe_scatter_cost.py",
                   "torch_probe_crossing_fix.py", "torch_irregular_mesh.py"):
        assert os.path.join("scripts", script) in names, script
    for mod in ("reference_api.py", "models/collision.py", "models/hashgrid.py",
                "ops/contact.py", "ops/stencils.py", "utils/scatter.py", "models/simulator.py",
                "models/tetmesh.py", "ops/boxstencil.py", "utils/boxmorton.py",
                "profiling.py", "io/checkpoint.py", "io/sharded.py", "parallel/comm.py",
                "parallel/hosts.py", "parallel/halo.py", "parallel/sharded.py",
                "parallel/gridsharded.py"):
        assert os.path.join("precond_tpu_torch", *mod.split("/")) in names, mod
