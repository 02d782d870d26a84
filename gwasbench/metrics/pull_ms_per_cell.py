"""The device-to-host copies of a cell (the port's ``pull`` spans: each
``BatchView`` pull, the screen probe and the t probe), over the window's
cells."""
from gwasbench import spans


def read(run):
    return spans.ms_per_cell(run, "pull")
