"""k1_roofline_pct: K1 (csrc/spd_inverse.cu) against the least time the
card needs for its work: the inverses of every level's domain blocks, the
blocks counted from the problem (the reference hierarchy's level sizes)."""

KERNEL = "spd_inverse96_kernel"


def read(ctx):
    times = ctx.trace.kernels.get(KERNEL) if ctx.trace else None
    if not times:
        return None
    r = ctx.roofline
    bound = r.bound_s(*r.k1_work(ctx.problem["blocks"]))
    return 100.0 * bound * len(times) / sum(times)
