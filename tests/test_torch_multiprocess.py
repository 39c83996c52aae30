"""The port's multi-rank solves against the JAX package's 8-device ones.

The test process computes the JAX references on its 8 virtual devices
(the solves of tests/test_halo.py, test_sharded.py and test_gridsharded.py)
and writes their inputs as npz. Then 2 and 4 gloo processes
(scripts/torch_multiprocess_worker.py, started as tests/test_multiprocess.py
starts its workers) run the port's multi-rank entries on the same inputs,
and this process runs them once more at world size 1 with no process
group. Each rank's rows of x are held to the JAX x with the JAX tests'
tolerances: iterations within 3 (the grid steps: 5), x to rtol 5e-3,
atol 5e-4 max|x| (the grid steps: atol only). The workers also make the
collective checkpoint round trips: a one-rank save loaded onto 2 and 4
ranks, and their saves loaded here by one process.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from precond_tpu.config import SchwarzConfig as JCfg
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops import blockcsr as jblockcsr
from precond_tpu.ops.contact import build_contact_ell as jbuild_contact_ell
from precond_tpu.ops.stencils import Stencils as JStencils
from precond_tpu.parallel import halo as jhalo
from precond_tpu.parallel.gridsharded import (
    sharded_grid_contact_solve_step as jsharded_grid_contact,
    sharded_grid_solve_step as jsharded_grid,
)
from precond_tpu.parallel.sharded import make_mesh as jmake_mesh
from precond_tpu.parallel.sharded import shard_system as jshard_system
from precond_tpu.parallel.sharded import sharded_solve_step as jsharded_solve_step
from precond_tpu.solver import compute_sort_maps as jsort_maps
from precond_tpu.solver import prepare_preconditioner as jprepare
from precond_tpu.utils import gridmorton as jgm

from precond_tpu_torch.io import sharded as shio
from precond_tpu_torch.models import collision as tcoll
from precond_tpu_torch.ops.stencils import build_stencils as tbuild_stencils
from precond_tpu_torch.parallel import hosts
from precond_tpu_torch.parallel.comm import Group, row_range

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "scripts", "torch_multiprocess_worker.py")
WORLDS = (1, 2, 4)
GRID_CASES = ("grid_sym0", "grid_sym1", "grid_contact")
STENCIL_FIELDS = ("idx", "weight", "nverts", "nfirst", "stiff", "direction", "valid")
WORKER_TIMEOUT = 240

torch.set_num_threads(2)


def _worker_module():
    spec = importlib.util.spec_from_file_location("torch_multiprocess_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _folded(grid, mass):
    """tests/test_halo.py's fold: the right half over the left at 0.5 h,
    with contact detected by the port (the same stencils go to both
    packages)."""
    mesh = jcloth.make_grid(grid, grid, z_wave=0.0, mass=mass, dt=1.0 / 60.0)
    n, h = mesh.num_verts, 1.0 / (grid - 1)
    p = np.asarray(mesh.positions).copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, 0.5 * h, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
    p = p.astype(np.float32)
    pos, fj, ej = torch.as_tensor(p), torch.as_tensor(mesh.faces), torch.as_tensor(mesh.edges)
    vf, _ = tcoll.detect_vf_grid(pos, fj, 0.75 * h, 1e3, n // 4, per_vertex_cap=2)
    ee, _ = tcoll.detect_ee_grid(pos, ej, 0.75 * h, 1e3, n // 4, per_edge_cap=2)
    st = tbuild_stencils(ej, fj, ee=ee, vf=vf)
    arrays = {f: getattr(st, f).numpy() for f in STENCIL_FIELDS}
    assert arrays["valid"].sum() > 50, "the fold must make contacts"
    return mesh, p, arrays


def _halo_inputs(ell_sorted, state, cfg, n, b_sorted, world, packed, max_iters, stencils=None):
    hs = jhalo.build_halo_system(ell_sorted, world)
    sap = jhalo.split_apply_state(state, cfg, n, num_shards=world)
    d = dict(diag=hs.diag, idx_ext=hs.idx_ext, blocks=hs.blocks, halo=hs.halo,
             shard_rows=hs.shard_rows, send_idx=hs.send_idx, recv_perm=hs.recv_perm,
             going_next_fine=sap.going_next_fine[:n], anc1=sap.anc1,
             going_next_coarse=sap.going_next_coarse, n=sap.n, total_coarse=sap.total_coarse,
             l1_live=sap.l1_live, b=b_sorted, max_iters=max_iters,
             symv_kernel="packed" if packed else "dense")
    if packed:
        for part in ("fine", "coarse"):
            inv = getattr(sap, f"inv_{part}")
            d.update({f"inv_{part}_f": inv.f, f"inv_{part}_dg": inv.dg, f"inv_{part}_nb": inv.nb})
    else:
        d.update(inv_fine=sap.inv_fine, inv_coarse=sap.inv_coarse)
    if stencils is not None:
        d.update({f"st_{f}": v for f, v in stencils.items()})
    return _np(d)


def _halo_cases(dmesh):
    """halo_dense / halo_packed / halo_contact: inputs per world, JAX x (sorted)."""
    out = {}
    mesh_c = jcloth.make_grid(32, 32, z_wave=0.02, mass=0.01)
    n = mesh_c.num_verts
    ell = jcloth.assemble_system(mesh_c)
    maps = jsort_maps(jnp.asarray(mesh_c.positions))
    ell_sorted = jblockcsr.permute(ell, maps.sorted_to_orig, maps.orig_to_sorted)
    for case, packed, seed in (("halo_dense", False, 0), ("halo_packed", True, 3)):
        cfg = JCfg(symv_kernel="packed") if packed else JCfg()
        state = jprepare(ell, maps, cfg)
        b = jnp.asarray(np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32))
        b_sorted = jnp.take(b, maps.sorted_to_orig, axis=0)
        sap8 = jhalo.split_apply_state(state, cfg, n, num_shards=8)
        ref = jhalo.solve_sorted(dmesh, cfg, jhalo.build_halo_system(ell_sorted, 8), sap8,
                                 b_sorted, tol=1e-4, max_iters=200)
        out[case] = ({w: _halo_inputs(ell_sorted, state, cfg, n, b_sorted, w, packed, 200)
                      for w in WORLDS}, np.asarray(ref.x), int(ref.iterations))

    cfg = JCfg()
    mesh_f, pos, st = _folded(32, 0.01)
    ell = jcloth.assemble_system(mesh_f, positions=pos)
    maps = jsort_maps(jnp.asarray(pos))
    sten = JStencils(**{f: jnp.asarray(v) for f, v in st.items()})
    state = jprepare(ell, maps, cfg, sten)
    o2s = maps.orig_to_sorted
    sorted_st = sten._replace(idx=jnp.where(
        sten.valid[:, None] & (jnp.arange(5) < sten.nverts[:, None]),
        jnp.take(o2s, jnp.clip(sten.idx, 0, n - 1)), 0))
    b = jnp.asarray(np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32))
    b_sorted = jnp.take(b, maps.sorted_to_orig, axis=0)
    ell_sorted = jblockcsr.permute(ell, maps.sorted_to_orig, maps.orig_to_sorted)
    ref = jhalo.solve_sorted(dmesh, cfg, jhalo.build_halo_system(ell_sorted, 8),
                             jhalo.split_apply_state(state, cfg, n), b_sorted, tol=1e-4,
                             max_iters=400, stencils=sorted_st)
    st_sorted = {f: np.asarray(getattr(sorted_st, f)) for f in STENCIL_FIELDS}
    out["halo_contact"] = ({w: _halo_inputs(ell_sorted, state, cfg, n, b_sorted, w, False, 400,
                                            st_sorted) for w in WORLDS},
                           np.asarray(ref.x), int(ref.iterations))
    return out


def _sharded_cases(dmesh):
    """sharded_32 / sharded_24 (ragged on 4 ranks): JAX x in original order."""
    out = {}
    cfg = JCfg()
    for side in (32, 24):
        mesh_c = jcloth.make_grid(side, side, z_wave=0.02, mass=0.01)
        ell = jcloth.assemble_system(mesh_c)
        maps = jsort_maps(jnp.asarray(mesh_c.positions))
        b = jnp.asarray(np.random.default_rng(0).standard_normal((mesh_c.num_verts, 3))
                        .astype(np.float32))
        with dmesh:
            ref = jsharded_solve_step(dmesh, cfg, max_iters=100)(jshard_system(dmesh, ell), maps, b)
        d = _np(dict(diag=ell.diag, idx=ell.idx, blocks=ell.blocks, mask=ell.mask,
                     s2o=maps.sorted_to_orig, o2s=maps.orig_to_sorted, b=b, max_iters=100,
                     symv_kernel="auto"))
        out[f"sharded_{side}"] = ({w: d for w in WORLDS}, np.asarray(ref.x), int(ref.iterations))
    return out


def _grid_cases():
    """grid_sym0 / grid_sym1 / grid_contact: JAX x in grid order."""
    out = {}
    k, grid, cfg = 5, 32, JCfg()
    gmesh = jmake_mesh()
    for sym in (False, True):
        mesh_c = jcloth.make_grid(grid, grid, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
        ssys = jcloth.assemble_system_stencil(mesh_c, sym=sym)
        dg, dr, full = jcloth.assemble_system_grid(mesh_c)
        b = jnp.asarray(np.random.default_rng(0).standard_normal((mesh_c.num_verts, 3))
                        .astype(np.float32))
        ref = jsharded_grid(gmesh, cfg, ssys.offsets, k, tol=1e-5, max_iters=300,
                            sym=sym)(ssys, dg, dr, b)
        d = _np(dict(diag_t=ssys.diag_t, dirs_t=ssys.dirs_t, offsets=np.asarray(ssys.offsets),
                     diag_rows=dg, dirs_rows=dr, full_offsets=np.asarray(full), b=b, k=k,
                     sym=sym, tol=1e-5, max_iters=300, symv_kernel="auto"))
        out[f"grid_sym{int(sym)}"] = ({w: d for w in WORLDS}, np.asarray(ref.x),
                                      int(ref.iterations))

    mesh_f, pos, st = _folded(grid, 0.001)
    n = mesh_f.num_verts
    sten = JStencils(**{f: jnp.asarray(v) for f, v in st.items()})
    ce = jbuild_contact_ell(sten, n, kc=16)
    ssys = jcloth.assemble_system_stencil(mesh_f, positions=pos)
    dg, dr, full = jcloth.assemble_system_grid(mesh_f, positions=pos)
    o2s = jnp.asarray(jgm.sort_maps(k)[1])
    b = jnp.asarray(np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32))
    ref = jsharded_grid_contact(gmesh, cfg, ssys.offsets, k, tol=1e-5, max_iters=400)(
        ssys, dg, dr, b, sten, ce, o2s)
    d = _np(dict(diag_t=ssys.diag_t, dirs_t=ssys.dirs_t, offsets=np.asarray(ssys.offsets),
                 diag_rows=dg, dirs_rows=dr, full_offsets=np.asarray(full), b=b, k=k,
                 sym=False, tol=1e-5, max_iters=400, o2s=o2s, symv_kernel="auto",
                 **{f"st_{f}": v for f, v in st.items()}))
    out["grid_contact"] = ({w: d for w in WORLDS}, np.asarray(ref.x), int(ref.iterations))
    return out


def _launch(world, inputs, outdir):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    hosts.launch_local_ranks([sys.executable, WORKER, "--inputs", inputs, "--out", outdir,
                              "--device", "cpu"], world, WORKER_TIMEOUT,
                             os.path.join(outdir, f"logs_w{world}"), env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX references, then the port at world sizes 1 (here), 2 and 4."""
    dmesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    cases = {**_halo_cases(dmesh), **_sharded_cases(dmesh), **_grid_cases()}
    inputs = str(tmp_path_factory.mktemp("inputs"))
    outdir = str(tmp_path_factory.mktemp("out"))
    for case, (per_world, _, _) in cases.items():
        for w, d in per_world.items():
            np.savez(os.path.join(inputs, f"{case}_w{w}.npz"), **d)
    worker = _worker_module()
    # the one-rank save the groups load (1 -> 2, 1 -> 4)
    shio.save_solver_sharded(os.path.join(inputs, "ckpt_w1"), worker.dcp_solver("cpu"),
                             x=torch.as_tensor(worker.dcp_x(1.0)))
    results = {1: {}}
    group = Group.single("cpu")
    for case, (per_world, _, _) in cases.items():
        res = worker.run_case(group, case, per_world[1])
        results[1][case] = [(res.x.numpy(), res.iterations, float(res.rel_residual))]
    for w in WORLDS[1:]:
        _launch(w, inputs, outdir)
        results[w] = {
            case: [tuple(np.load(os.path.join(outdir, f"{case}_w{w}_r{r}.npz"))[key][()]
                         for key in ("x", "iterations", "rel_residual")) for r in range(w)]
            for case in cases}
        results[w]["dcp"] = [dict(np.load(os.path.join(outdir, f"dcp_w{w}_r{r}.npz")))
                             for r in range(w)]
    refs = {case: (x, it) for case, (_, x, it) in cases.items()}
    return refs, results, inputs, worker


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ("halo_dense", "halo_packed", "halo_contact", "sharded_32",
                                  "sharded_24", *GRID_CASES))
def test_multirank_matches_jax(runs, case, world):
    refs, results, _, _ = runs
    x_ref, it_ref = refs[case]
    per_rank = results[world][case]
    n = x_ref.shape[0]
    scale = np.abs(x_ref).max()
    band, rtol = (5, 0.0) if case in GRID_CASES else (3, 5e-3)
    for rank, (x, iters, rel) in enumerate(per_rank):
        if case.startswith("sharded"):
            start, stop = row_range(n, world, rank)     # original order, chunk layout
        else:
            per = n // world                            # sorted (halo) or grid rows
            start, stop = rank * per, (rank + 1) * per
        assert abs(int(iters) - it_ref) <= band, (case, world, rank, iters, it_ref)
        assert rel <= (1e-5 if case.startswith("grid") else 1e-4)
        np.testing.assert_allclose(x, x_ref[start:stop], rtol=rtol, atol=5e-4 * scale)
    # one SPMD program: every rank ran the same iterations
    assert len({int(it) for _, it, _ in per_rank}) == 1


def test_ragged_case_pads_on_four_ranks(runs):
    """24x24 = 576 rows: a multiple of 2 * 32 but not of 4 * 32, so the
    4-rank step pads in sorted space (to 640) and still returns 576 rows."""
    _, results, _, _ = runs
    assert 576 % (4 * 32) and not 576 % (2 * 32)
    assert sum(x.shape[0] for x, _, _ in results[4]["sharded_24"]) == 576
    assert [x.shape[0] for x, _, _ in results[4]["sharded_24"]] == [144] * 4


@pytest.mark.parametrize("world", WORLDS[1:])
def test_checkpoint_reshards(runs, world):
    """One-rank save -> `world` ranks (each reads its rows); the group's
    save, each rank writing only its rows -> back onto the group and onto
    one process here, where no rank's rows may be missing."""
    _, results, inputs, worker = runs
    for flags in results[world]["dcp"]:
        assert bool(flags["dcp_from_one"]) and bool(flags["dcp_roundtrip"])
    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner

    pre = SchwarzPreconditioner(SchwarzConfig(), device="cpu")
    x = shio.load_solver_sharded(os.path.join(inputs, f"ckpt_w{world}"), pre)
    assert torch.equal(x, torch.as_tensor(worker.dcp_x(2.0)))
    assert torch.equal(pre.state.inv96, worker.dcp_solver("cpu").state.inv96)
