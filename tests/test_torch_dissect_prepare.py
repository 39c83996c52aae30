"""The port's twins of the JAX package's prepare dissections, on the CPU at
16^2: scripts/torch_profile_prepare.py against profile_prepare.py (K = 2),
torch_profile_prepare_grid.py against profile_prepare_grid.py (K = 2) and
torch_profile_assembly.py against profile_assembly.py (K = 2).

Each JAX script runs with BENCH_GRID and PROF_K set; its components (the
lambdas it hands to its timing calls, tests/dissect_support) are applied
once to the script's own inputs, and the twin's component of the same
name to those inputs carried through convert.py. Tolerances, the JAX
package's own: integers (sort maps, hierarchy, ancestor tables, one-hot
operators) bit for bit; assembled blocks and row contributions at atol
1e-6 * max|h| (tests/test_torch_assembly.py:54); inverses at rtol 2e-4,
atol 1e-5 (tests/test_gridprep.py:110); single apply-side ops at rtol
1e-5, atol 1e-6 * max|z|. Each twin prints the JAX script's line names, in
its order. profile_assembly.py calls `_level_rows` with an older signature
and raises there: its per-level and row-scatter lines are held against
`_level_rows` / `_row_scatter` of the JAX package called as
assemble_banked_hessian calls them now, on the script's own arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_support import close, closure, jax_script, line_names, np_, twin_lines

from precond_tpu.ops import assembly as jasm
from precond_tpu_torch import convert
from precond_tpu_torch.ops.hierarchy import BANK

import torch_profile_assembly as tw_asm
import torch_profile_prepare as tw_prep
import torch_profile_prepare_grid as tw_grid

torch.set_num_threads(2)

CPU = torch.device("cpu")
ENV = {"BENCH_GRID": 16, "PROF_K": 2}


def _ell(j):
    return convert.block_ell_from_numpy(np_(j.diag), np_(j.idx), np_(j.blocks), np_(j.mask),
                                        device="cpu")


def _inverse_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-4, atol=1e-5)


def _assembly_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-6 * np.abs(want).max())


# ---- profile_prepare -----------------------------------------------------------

@pytest.fixture(scope="module")
def prep_run():
    with pytest.MonkeyPatch.context() as mp:
        run = jax_script("profile_prepare", mp, ENV)
    g = run.g
    s = tw_prep.setup(16, CPU)
    s.ell = _ell(g["ell"])
    s.maps = convert.sort_maps_from_numpy(np_(g["maps"].sorted_to_orig),
                                          np_(g["maps"].orig_to_sorted), device="cpu")
    s.positions = torch.as_tensor(np_(g["mesh"].positions))
    tw_prep.component_inputs(s)
    # jitted: ells, hier, h96; six chains; prep; the two single lambdas
    chains = [closure(f, "op") for f in run.jitted[3:9]]
    return run, s, chains + run.jitted[10:12]


def test_prepare_inputs_match(prep_run):
    run, s, _ = prep_run
    g = run.g
    for field in ("idx", "mask", "diag", "blocks"):
        np.testing.assert_array_equal(getattr(s.ells, field).numpy(),
                                      np_(getattr(g["ells"], field)))
    np.testing.assert_array_equal(s.hier.going_next.numpy(), np_(g["hier"].going_next))
    _assembly_close(s.h96.numpy(), np_(g["h96"]))


def _prep_jax_args(g):
    ells, hier = g["ells"], g["hier"]
    return {"floor (scaled copy)": (ells.diag,),
            "permute ELL": (ells.diag, g["ell"], g["maps"]),
            "build_hierarchy": (ells.mask.astype(jnp.float32), ells.idx),
            "restriction_operators": (hier.going_next.astype(jnp.float32),),
            "assemble": (ells.diag, ells, hier),
            "invert panel": (g["h96"],),
            "prepare (single)": (g["ell"], g["maps"]),
            "sort maps (single)": (jnp.asarray(g["mesh"].positions),)}


@pytest.mark.parametrize("i", range(len(tw_prep.COMPONENTS)),
                         ids=[c[0] for c in tw_prep.COMPONENTS])
def test_prepare_component(prep_run, i):
    run, s, ops = prep_run
    name, fn, names, _ = tw_prep.COMPONENTS[i]
    want = np_(ops[i](*_prep_jax_args(run.g)[name]))
    got = fn(s, *tw_prep.args_of(s, names)).numpy()
    if name in ("build_hierarchy", "restriction_operators", "sort maps (single)"):
        np.testing.assert_array_equal(got, want)
    elif name in ("assemble",):
        _assembly_close(got, want)
    elif name in ("invert panel", "prepare (single)"):
        _inverse_close(got, want)
    else:
        close(got, want)


def test_prepare_whole_state(prep_run):
    run, s, _ = prep_run
    want = run.g["prep"](run.g["ell"], run.g["maps"])[0]
    got = tw_prep.prepare(s, s.ell, s.maps)[0]
    _inverse_close(got.inv96.numpy(), np_(want.inv96))
    np.testing.assert_array_equal(got.restrict_pos.numpy(), np_(want.restrict_pos))


def test_prepare_names(prep_run, monkeypatch, capsys):
    run = prep_run[0]
    names = [c[0] for c in tw_prep.COMPONENTS]
    out = twin_lines(tw_prep, monkeypatch, capsys, ENV)
    assert line_names(out, names) == line_names(run.out, names) == names
    assert out.splitlines()[0] == run.out.splitlines()[0]
    # the first-prepare split comes before the components
    firsts = line_names(out, ("prepare (first call)", "prepare (after empty_cache)"))
    assert firsts == ["prepare (first call)", "prepare (after empty_cache)"]
    lines = out.splitlines()
    assert lines.index(next(x for x in lines if x.startswith("prepare (after"))) < \
        lines.index(next(x for x in lines if x.startswith("floor")))


# ---- profile_prepare_grid --------------------------------------------------------

@pytest.fixture(scope="module")
def grid_run():
    with pytest.MonkeyPatch.context() as mp:
        run = jax_script("profile_prepare_grid", mp, ENV)
    g = run.g
    s = tw_grid.setup(16, CPU)
    s.dgr, s.drr, offsets = convert.grid_blocks_from_numpy(np_(g["dgr"]), np_(g["drr"]),
                                                            g["goffsets"], device="cpu")
    assert offsets == s.goffsets
    s.h96 = tw_grid.assemble(s, s.dgr, s.drr)
    # jitted: h96, then a (K, 3K) pair of chains per line
    return run, s, [closure(f, "op") for f in run.jitted[1::2]]


@pytest.mark.parametrize("i", range(len(tw_grid.LINES)), ids=[c[0] for c in tw_grid.LINES])
def test_prepare_grid_line(grid_run, i):
    run, s, ops = grid_run
    name, fn, names = tw_grid.LINES[i]
    jargs = {"dgr": run.g["dgr"], "drr": run.g["drr"], "h96": run.g["h96"]}
    want = np_(ops[i](*[jargs[a] for a in names]))
    got = fn(s, *[getattr(s, a) for a in names]).numpy()
    (_assembly_close if name == "assemble_grid_hessian" else _inverse_close)(got, want)


def test_prepare_grid_names(grid_run, monkeypatch, capsys):
    run = grid_run[0]
    names = [c[0] for c in tw_grid.LINES]
    out = twin_lines(tw_grid, monkeypatch, capsys, ENV)
    assert line_names(out, names) == line_names(run.out, names) == names
    assert out.splitlines()[0] == run.out.splitlines()[0]


# ---- profile_assembly --------------------------------------------------------------

@pytest.fixture(scope="module")
def asm_run():
    with pytest.MonkeyPatch.context() as mp:
        run = jax_script("profile_assembly", mp, ENV, raises=(TypeError,))
    assert "_level_rows" in str(run.error)
    return run, tw_asm.setup(16, CPU)


def test_assembly_setup_matches(asm_run):
    """The twin derives the script's ancestor-table terms bit for bit."""
    run, s = asm_run
    g = run.g
    np.testing.assert_array_equal(s.ells.idx.numpy(), np_(g["ells"].idx))
    np.testing.assert_array_equal(s.gn.numpy(), np_(g["gn"]))
    np.testing.assert_array_equal(s.anc.numpy(), np_(g["anc"]))
    np.testing.assert_array_equal(s.lam.numpy(), np_(g["lam"]))
    np.testing.assert_array_equal(s.ok.numpy(), np_(g["ok"]))
    lane_ot = jnp.take_along_axis(g["otanc"], g["lam"][:, :, None], axis=2)[:, :, 0] % BANK
    np.testing.assert_array_equal(s.lane_ot.numpy(), np_(lane_ot))


def test_assembly_chained_lines(asm_run):
    """floor, anc table, otanc gather and assemble full: the script's own
    chained ops (jitted: ells, hier, the floor chain, anc, then the
    chains) once each, on its arrays."""
    run, s = asm_run
    g = run.g
    floor, anc_t, otanc, full = (closure(run.jitted[i], "op") for i in (2, 4, 5, 6))
    ells = g["ells"]
    close(tw_asm.floor(s, torch.as_tensor(np_(ells.diag))).numpy(), np_(floor(ells.diag)))
    gnf = g["gn"].astype(jnp.float32)
    np.testing.assert_array_equal(tw_asm.anc_table(s, torch.as_tensor(np_(gnf))).numpy(),
                                  np_(anc_t(gnf)))
    idxf = ells.idx.astype(jnp.float32)
    np.testing.assert_array_equal(
        tw_asm.otanc_gather(s, torch.as_tensor(np_(idxf)), s.anc, s.ells.idx).numpy(),
        np_(otanc(idxf, g["anc"], ells.idx)))
    tells = _ell(ells)
    _assembly_close(tw_asm.assemble_full(s, tells.diag, tells, s.hier).numpy(),
                    np_(full(ells.diag, ells, g["hier"])))


@pytest.mark.parametrize("level", [0, 1])
def test_assembly_level_rows(asm_run, level):
    run, s = asm_run
    g = run.g
    lane_ot = jnp.take_along_axis(g["otanc"], g["lam"][:, :, None], axis=2)[:, :, 0] % BANK
    lane_my = g["myanc"][:, level] % BANK
    want = jasm._level_rows(lane_ot, g["lam"], g["ok"], g["blk9"], lane_my, g["dself9"], level)
    t = [torch.as_tensor(np_(a)) for a in (g["dself9"], lane_ot, g["lam"], g["ok"], g["blk9"],
                                           lane_my)]
    _assembly_close(tw_asm.level_rows(s, level, *t).numpy(), np_(want))


def test_assembly_row_scatter(asm_run):
    run, s = asm_run
    g = run.g
    n, total = s.n, s.total
    vals = np.random.default_rng(5).standard_normal((n, jasm.ROW)).astype(np.float32)
    rows = g["myanc"][:, 1]
    hb0 = jnp.zeros((total + 1, jasm.ROW), jnp.float32)
    want = jasm._row_scatter(hb0, rows, jnp.asarray(vals), rows < total, total)[:n]
    got = tw_asm.row_scatter(s, torch.as_tensor(vals), s.hb0, torch.as_tensor(np_(rows)))
    _assembly_close(got.numpy(), np_(want))


def test_assembly_names(asm_run, monkeypatch, capsys):
    """The twin prints the script's names; the JAX run stops at its first
    `_level_rows` line."""
    run, s = asm_run
    names = (["floor (scaled copy)", "anc table", "otanc gather [N,K,L]", "assemble full"]
             + [f"_level_rows l={lv}" for lv in range(s.levels)] + ["_row_scatter level-1"])
    assert [name for name, _, _ in tw_asm.lines(s)] == names
    out = twin_lines(tw_asm, monkeypatch, capsys, ENV)
    assert line_names(out, names) == names
    assert line_names(run.out, names) == names[:4]
    assert out.splitlines()[0] == run.out.splitlines()[0]
