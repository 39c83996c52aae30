"""kernels_per_frame: device kernels launched in the traced frames, per frame
(launch pacing)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.frames or not t.kernels:
        return None
    return sum(len(d) for d in t.kernels.values()) / t.frames
