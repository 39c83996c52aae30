"""Shared by the dissection tests (tests/test_torch_dissect*.py): run one of
the JAX package's measurement scripts (scripts/profile_*.py, ...) on the
CPU and reach what it defined, and run a torch twin's main.

A JAX script runs as `runpy.run_path` would run it, but into a namespace
the test keeps, so one that raises part-way (a stale call in the JAX
script) still gives the functions and arrays it defined before. Every
function the script hands to `jax.jit` is recorded in order: the
components that the scripts write as lambdas inside their timing calls
are reached through those functions' closures.
"""

import contextlib
import io
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)


def jax_script(name: str, monkeypatch, env: dict, raises=()) -> SimpleNamespace:
    """Run scripts/<name>.py with `env` set; returns its namespace (g), the
    functions it passed to jax.jit (jitted, in order), its printed output
    (out) and the exception of a type in `raises` that stopped it (error)."""
    for key, value in env.items():
        monkeypatch.setenv(key, str(value))
    path = os.path.join(SCRIPTS, f"{name}.py")
    jitted, real_jit = [], jax.jit

    def spy(fun=None, *args, **kwargs):
        if getattr(getattr(fun, "__code__", None), "co_filename", None) == path:
            jitted.append(fun)
        return real_jit(fun, *args, **kwargs)

    monkeypatch.setattr(jax, "jit", spy)
    g = {"__name__": f"jax_{name}", "__file__": path}
    buf, error = io.StringIO(), None
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    with contextlib.redirect_stdout(buf):
        try:
            exec(code, g)
        except raises as e:
            error = e
    monkeypatch.setattr(jax, "jit", real_jit)
    return SimpleNamespace(g=g, jitted=jitted, out=buf.getvalue(), error=error)


def closure(fn, var: str):
    """The value `fn` closes over under the name `var`."""
    return fn.__closure__[fn.__code__.co_freevars.index(var)].cell_contents


def line_names(text: str, names) -> list:
    """The known line names in printed output, in the order printed."""
    out = []
    for line in text.splitlines():
        hits = [nm for nm in names if line.startswith(nm + " ") or line.startswith(nm + ":")]
        if hits:
            out.append(max(hits, key=len))
    return out


def twin_lines(module, monkeypatch, capsys, env: dict) -> str:
    """What a twin's main prints with --device cpu and `env` set."""
    for key, value in env.items():
        monkeypatch.setenv(key, str(value))
    capsys.readouterr()
    assert module.main(["--device", "cpu"]) == 0
    return capsys.readouterr().out


def close(got, want, rtol=1e-5, atol_rel=1e-6):
    """rtol, and atol relative to max|want| (the JAX package's apply test)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


def np_(a):
    return np.array(a)
