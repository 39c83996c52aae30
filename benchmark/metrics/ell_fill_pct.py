"""ell_fill_pct: the share of the padded block-ELL slots that hold a stored
off-diagonal block, in the system the general path's SpMV iterates on (the
program's counters `spmv.ell_stored` / `spmv.ell_slots`, set on the host
when the simulator is built). The SpMV kernel reads only the stored slots,
so this is the share of the padded layout it reads, not of its work. None
where the program keeps no such counters."""


def read(ctx):
    try:
        from precond_tpu_torch import profiling
    except ImportError:
        return None
    counts = getattr(profiling, "counters", dict)()
    slots, stored = counts.get("spmv.ell_slots"), counts.get("spmv.ell_stored")
    if not slots or stored is None:
        return None
    return 100.0 * stored / slots
