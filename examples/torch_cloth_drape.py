"""Pinned cloth draping under gravity with self-collision penalties, on the
PyTorch port (twin of examples/cloth_drape.py).

Run:  python examples/torch_cloth_drape.py [grid] [steps] [--device cpu|cuda]
Prints per-frame solve stats and writes the final mesh to
examples/out_torch_cloth.npz (positions + faces).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("grid", type=int, nargs="?", default=32)
    ap.add_argument("steps", type=int, nargs="?", default=30)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args()
    import torch

    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.models.simulator import ClothSim

    grid = args.grid
    mesh = cloth.make_grid(grid, grid, mass=0.02, dt=1.0 / 60.0,
                           k_struct=5e3, k_shear=5e3, k_bend=50.0)
    pinned = np.arange(grid)  # top row
    sim = ClothSim(mesh, SchwarzConfig(), pinned=pinned, collision_stiffness=2e3,
                   collision_threshold=0.01, collision_budget=256, device=args.device)
    for i in range(args.steps):
        t0 = time.perf_counter()
        st = sim.step()
        if args.device == "cuda":
            torch.cuda.synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        print(f"frame {i:3d}: pcg_iters={sim.last_solve.iterations:4d} "
              f"rel_res={float(sim.last_solve.rel_residual):.2e} wall={dt_ms:7.1f} ms "
              f"z_mean={float(st.positions[:, 2].mean()):+.4f}", flush=True)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out_torch_cloth.npz")
    np.savez(out, positions=sim.state.positions.cpu().numpy(), faces=mesh.faces)
    print("wrote", out)


if __name__ == "__main__":
    main()
