"""Shared by the dissection and probe tests (tests/test_torch_dissect*.py,
tests/test_torch_probes_*.py): run one of the JAX package's measurement or
probe scripts (scripts/profile_*.py, scripts/probe_*.py, ...) on the CPU
and reach what it defined, call a JAX script's main, parse a probe scan's
lines, and run a torch twin's main.

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
import re
import sys
from types import SimpleNamespace

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
for _p in (SCRIPTS, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


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


def run_main(run: SimpleNamespace, argv, raises=()) -> SimpleNamespace:
    """Call a JAX script's main() (one that runs only under __main__) with
    sys.argv = [its path] + argv; its printed output is added to run.out,
    the exception of a type in `raises` that stopped it goes to run.error."""
    saved = sys.argv
    sys.argv = [run.g["__file__"]] + [str(a) for a in argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            run.g["main"]()
    except raises as e:
        run.error = e
    finally:
        sys.argv = saved
    run.out += buf.getvalue()
    return run


def fault_line(error: BaseException, path: str) -> int:
    """The line of `path` at which `error` was raised (the innermost frame
    of that file in its traceback)."""
    tb, line = error.__traceback__, None
    while tb is not None:
        if tb.tb_frame.f_code.co_filename == path:
            line = tb.tb_lineno
        tb = tb.tb_next
    return line


_PAIR = re.compile(r"(?<![\w/])([A-Za-z][\w.]*)=\s*(\S+)")


def parse_scan(text: str) -> dict:
    """A probe scan's lines ("stiff=   1e+03  static=   224  ...") as
    {stiffness: {column: iterations}}; the column of a damping theta is
    the float theta ("th0.5=..." -> 0.5). Ratios (j/static=...) are left out."""
    out = {}
    for line in text.splitlines():
        pairs = dict(_PAIR.findall(line))
        if "stiff" not in pairs or not line.startswith("stiff="):
            continue
        stiff = float(pairs.pop("stiff"))
        out[stiff] = {(float(k[2:]) if k.startswith("th") else k): int(v) for k, v in pairs.items()}
    return out


def assert_probe_count(got: int, want: int, stiff: float) -> None:
    """A twin's iteration count against the JAX script's: equal at 1e3, in
    chip_smoke.py's [contact probes] band above (chip_smoke.PROBE_BANDS:
    from 1e4 up the counts move with the summation order)."""
    import chip_smoke

    if stiff == 1e3:
        assert got == want, (got, want)
        return
    lo, hi = chip_smoke.probe_band(want, stiff)
    assert lo <= got <= hi, (got, want, lo, hi)
