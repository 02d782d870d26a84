"""Bytes a cell copies from the card to the host (the port's
``d2h_bytes`` counter in its ``pull`` spans), in MiB, over the window's
cells."""
from gwasbench import spans


def read(run):
    n = spans.cells(run)
    if n <= 0:
        return None
    return spans.counter(run, "d2h_bytes") / 2**20 / n
