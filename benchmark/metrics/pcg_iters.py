"""pcg_iters: PCG iterations per frame, the mean over the window's frames
(the program's own count, `ClothSim.last_solve.iterations`)."""

import statistics


def read(ctx):
    return statistics.fmean(ctx.iters) if ctx.iters else None
