"""The hierarchy branch the 4M-vertex north star takes by default: one level
more than the apply uses.

At 2048^2 SchwarzConfig.num_levels gives 5 levels and max_applied_levels is
4, so ``top = min(levels, cfg.max_applied_levels)`` truncates the top-down
coarse sum. At 64^2 num_levels is 3; max_applied_levels = 2 takes the same
branch. Each case runs the port and the JAX package on the same seeded
inputs (each prepares its own state) and holds the port to the JAX
function with the tolerance of that path's existing multi-rank test
(tests/test_torch_multiprocess.py): the halo solve to 3 iterations and x to
rtol 5e-3, atol 5e-4 max|x|; the sharded grid step to 5 iterations and x
to atol 5e-4 max|x|. A last check in each case shows that the branch
changes the result against the untruncated apply.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from precond_tpu.config import SchwarzConfig as JCfg
from precond_tpu.models import cloth as jcloth
from precond_tpu.parallel import halo as jhalo
from precond_tpu.parallel.gridsharded import sharded_grid_solve_step as jsharded_grid
from precond_tpu.parallel.sharded import make_mesh as jmake_mesh
from precond_tpu.solver import SortMaps as JSortMaps
from precond_tpu.solver import prepare_with_system as jprepare_with_system
from precond_tpu.utils import gridmorton as jgm

from precond_tpu_torch import SchwarzConfig
from precond_tpu_torch.models import cloth
from precond_tpu_torch.parallel import gridsharded as gsh
from precond_tpu_torch.parallel import halo
from precond_tpu_torch.parallel.comm import Group
from precond_tpu_torch.solver import SortMaps, prepare_with_system
from precond_tpu_torch.utils import gridmorton as gm

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

torch.set_num_threads(2)

GRID, K = 64, 6
N = GRID * GRID
TRUNC = dict(max_applied_levels=2)


def test_64_has_one_level_more_than_the_truncated_apply():
    cfg = SchwarzConfig(**TRUNC)
    assert cfg.num_levels(N) == 3 == JCfg().num_levels(N)
    assert min(cfg.num_levels(N), cfg.max_applied_levels) == cfg.num_levels(N) - 1
    # the north star's default: 5 levels, 4 applied
    assert SchwarzConfig().num_levels(2048 * 2048) == 5
    assert SchwarzConfig().max_applied_levels == 4


def _b(seed=0):
    return np.random.default_rng(seed).standard_normal((N, 3)).astype(np.float32)


def _port_halo(cfg):
    """The port's halo path at world 1 on the tile-order sorted system
    (scripts/torch_scaling_capacity.py's halo path on the CPU)."""
    mesh = cloth.make_grid(GRID, GRID, z_wave=0.02, mass=0.001)
    ell = cloth.assemble_system(mesh, device="cpu")
    maps = SortMaps(*(torch.as_tensor(m) for m in gm.sort_maps(K)))
    state, ell_sorted = prepare_with_system(ell, maps, cfg)
    hsys = halo.build_halo_system(ell_sorted, 1)
    sap = halo.split_apply_state(state, cfg, N, num_shards=1)
    return halo.solve_sorted(Group.single("cpu"), cfg, hsys, sap, torch.as_tensor(_b()),
                             tol=1e-4, max_iters=300)


@pytest.mark.parametrize("symv", ["dense", "packed"])
def test_halo_solve_truncated_hierarchy_matches_jax(symv):
    jcfg = JCfg(symv_kernel=symv, **TRUNC)
    mesh = jcloth.make_grid(GRID, GRID, z_wave=0.02, mass=0.001)
    ell = jcloth.assemble_system(mesh)
    s2o, o2s = jgm.sort_maps(K)
    state, ell_sorted = jprepare_with_system(ell, JSortMaps(jnp.asarray(s2o), jnp.asarray(o2s)),
                                             jcfg)
    dmesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    ref = jhalo.solve_sorted(dmesh, jcfg, jhalo.build_halo_system(ell_sorted, 4),
                             jhalo.split_apply_state(state, jcfg, N, num_shards=4),
                             jnp.asarray(_b()), tol=1e-4, max_iters=300)
    x_ref, it_ref = np.asarray(ref.x), int(ref.iterations)

    cfg = SchwarzConfig(symv_kernel=symv, **TRUNC)
    got = _port_halo(cfg)
    x = got.x.numpy()
    scale = np.abs(x_ref).max()
    assert abs(got.iterations - it_ref) <= 3, (got.iterations, it_ref)
    assert float(got.rel_residual) <= 1e-4
    np.testing.assert_allclose(x, x_ref, rtol=5e-3, atol=5e-4 * scale)

    full = _port_halo(dataclasses.replace(cfg, max_applied_levels=4))
    assert (full.iterations != got.iterations
            or np.abs(full.x.numpy() - x).max() > 5e-3 * scale), "the branch changed nothing"


def _port_grid_step(cfg, b):
    mesh = cloth.make_grid(GRID, GRID, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    ssys = cloth.assemble_system_stencil(mesh, device="cpu")
    dg, dr, _ = cloth.assemble_system_grid(mesh, device="cpu")
    step = gsh.sharded_grid_solve_step(Group.single("cpu"), cfg, ssys.offsets, K, tol=1e-5,
                                       max_iters=300, device="cpu")
    return step(ssys, dg, dr, b)


def test_sharded_grid_step_truncated_hierarchy_matches_jax():
    jcfg = JCfg(**TRUNC)
    mesh = jcloth.make_grid(GRID, GRID, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    ssys = jcloth.assemble_system_stencil(mesh)
    dg, dr, _ = jcloth.assemble_system_grid(mesh)
    ref = jsharded_grid(jmake_mesh(), jcfg, ssys.offsets, K, tol=1e-5, max_iters=300)(
        ssys, dg, dr, jnp.asarray(_b()))
    x_ref, it_ref = np.asarray(ref.x), int(ref.iterations)

    cfg = SchwarzConfig(**TRUNC)
    got = _port_grid_step(cfg, torch.as_tensor(_b()))
    x = got.x.numpy()
    scale = np.abs(x_ref).max()
    assert abs(got.iterations - it_ref) <= 5, (got.iterations, it_ref)
    np.testing.assert_allclose(x, x_ref, rtol=0.0, atol=5e-4 * scale)

    full = _port_grid_step(dataclasses.replace(cfg, max_applied_levels=4), torch.as_tensor(_b()))
    assert (full.iterations != got.iterations
            or np.abs(full.x.numpy() - x).max() > 5e-4 * scale), "the branch changed nothing"
