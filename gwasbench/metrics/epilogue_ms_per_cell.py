"""Device time of a cell's epilogue after the product (the port's
``epilogue`` span of the dense step, bracketed by CUDA events: t, masks,
the sparse or dense p-value epilogue, the omnibus), over the window's
cells."""
from gwasbench import spans


def read(run):
    return spans.ms_per_cell(run, "epilogue", "device_s")
