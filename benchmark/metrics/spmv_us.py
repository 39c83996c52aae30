"""spmv_us: device busy of one SpMV of the PCG (the program's span
`pcg.spmv`: K4, the block-ELL kernel, and the contact SpMV where the frame
has contact), us a call, in the labelled frame traced with spans on."""

from benchmark import spans


def read(ctx):
    return spans.spmv_us(ctx.spans)
