"""k2_roofline_pct: K2 (csrc/packed_symv.cu), one launch per preconditioner
apply, against the least time the card needs for the symmetric matvec of
every level's domain blocks."""

KERNEL = "packed_symv96_kernel"


def read(ctx):
    times = ctx.trace.kernels.get(KERNEL) if ctx.trace else None
    if not times:
        return None
    r = ctx.roofline
    bound = r.bound_s(*r.k2_work(ctx.problem["blocks"]))
    return 100.0 * bound * len(times) / sum(times)
