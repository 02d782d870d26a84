"""Device time of a cell's association product (the port's ``product``
span of the dense step, bracketed by CUDA events on the card's clock: the
``block_p``-wide GEMM loop), over the window's cells."""
from gwasbench import spans


def read(run):
    return spans.ms_per_cell(run, "product", "device_s")
