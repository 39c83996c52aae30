"""Self-colliding folded sheet on the PyTorch port (twin of
examples/cloth_fold_contact.py): contact detection, fill-in and penalty
forces resolving a proximity violation.

A 2^k x 2^k cloth is folded onto itself half a grid-spacing apart (under
the detection threshold). Each frame the simulator detects VF/EE/EF sets
through the hash-grid broad phase, adds the contact Hessians to H and M,
adds gap-aware penalty forces to the rhs, and solves with the multilevel
Schwarz PCG on the static grid path. The fold gap opens toward the rest
separation while the solve stays converged.

    python examples/torch_cloth_fold_contact.py [--grid 32] [--frames 12] [--device cpu|cuda]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args()
    import torch

    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.models.simulator import ClothSim

    grid = args.grid
    mesh = cloth.make_grid(grid, grid, z_wave=0.0, mass=0.002, dt=1.0 / 60.0,
                           k_struct=2e3, k_shear=2e3, k_bend=20.0)
    n = mesh.num_verts
    h = 1.0 / (grid - 1)
    # fold the right half over the left, 0.5 spacings above
    p = np.asarray(mesh.positions).copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, 0.5 * h, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
    # pin the crease column of both layers so the fold cannot just fly apart
    crease = np.flatnonzero(np.abs(p[:, 0] - 0.5) < 0.25 * h)
    sim = ClothSim(mesh, SchwarzConfig(), gravity=(0.0, 0.0, 0.0), pinned=crease,
                   collision_stiffness=2e3, collision_threshold=0.75 * h,
                   collision_budget=max(n // 2, 256), collision_cell_cap=32, device=args.device)
    sim.state = sim.state._replace(
        positions=torch.as_tensor(p.astype(np.float32), device=sim.device))

    frames = []
    for f in range(args.frames):
        t0 = time.perf_counter()
        st = sim.step()
        pos = st.positions.cpu().numpy()
        wall = (time.perf_counter() - t0) * 1e3
        gap = pos[fold, 2].mean() - pos[~fold, 2].mean()
        print(f"frame {f:3d}: pcg_iters={sim.last_solve.iterations:4d} "
              f"rel_res={float(sim.last_solve.rel_residual):.2e} "
              f"gap={gap / h:5.3f} h  wall={wall:7.1f} ms", flush=True)
        frames.append(pos)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out_torch_cloth_fold.npz")
    np.savez_compressed(out, positions=np.stack(frames), faces=mesh.faces)
    print("wrote", out)


if __name__ == "__main__":
    main()
