"""Deformable tet box pinned at the top face, settling under gravity, on
the PyTorch port (twin of examples/softbody_drop.py).

Power-of-two box dims take the structured-box path (analytic 3-D tile
ordering, arithmetic hierarchy, stencil SpMV):

    python examples/torch_softbody_drop.py [--dims 8,8,8] [--frames 24]
        [--material linear|corotational|neohookean] [--device cpu|cuda]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", default="8,8,8")
    ap.add_argument("--frames", type=int, default=24)
    # corotational reassembles the warped-stiffness Hessian every step
    ap.add_argument("--material", default="linear",
                    choices=("linear", "corotational", "neohookean"))
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args()
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import tetmesh
    from precond_tpu_torch.models.simulator import SoftBodySim

    dims = tuple(int(v) for v in args.dims.split(","))
    mesh = tetmesh.make_box(*dims, mass=0.05, youngs=5e4)
    nz = dims[2]
    top = np.flatnonzero(np.arange(mesh.num_verts) % nz == nz - 1)
    sim = SoftBodySim(mesh, SchwarzConfig(), pinned=top, max_iters=400,
                      material=args.material, device=args.device)
    print(f"box {dims} = {mesh.num_verts} verts, {len(mesh.tets)} tets, "
          f"material: {args.material}, box path: {sim._box is not None}")

    frames = []
    for f in range(args.frames):
        t0 = time.perf_counter()
        state = sim.step()
        pos = state.positions.cpu().numpy()
        wall = (time.perf_counter() - t0) * 1e3
        print(f"frame {f:3d}: pcg_iters={sim.last_solve.iterations:4d} "
              f"rel_res={float(sim.last_solve.rel_residual):.2e} "
              f"wall={wall:7.1f} ms z_mean={pos[:, 2].mean():.4f}", flush=True)
        frames.append(pos)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out_torch_softbody.npz")
    np.savez_compressed(out, positions=np.stack(frames), tets=mesh.tets)
    print("wrote", out)


if __name__ == "__main__":
    main()
