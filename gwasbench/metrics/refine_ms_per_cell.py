"""The canonical refine of a cell on the host (the port's ``refine``
spans: ``core/stats.py::refine_neglog10p`` inside its lock), over the
window's cells."""
from gwasbench import spans


def read(run):
    return spans.ms_per_cell(run, "refine")
