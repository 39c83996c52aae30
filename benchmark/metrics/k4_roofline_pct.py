"""k4_roofline_pct: K4 (csrc/stencil_spmv.cu), one launch per SpMV on the
grid path, against the least time the card needs for the stencil product
over every vertex and direction plane."""

KERNEL = "stencil_spmv_kernel"


def read(ctx):
    times = ctx.trace.kernels.get(KERNEL) if ctx.trace else None
    if not times or not ctx.problem["planes"]:
        return None
    r = ctx.roofline
    bound = r.bound_s(*r.k4_work(ctx.problem["n"], ctx.problem["planes"]))
    return 100.0 * bound * len(times) / sum(times)
