"""Time the compute thread waits for the next decoded batch (the port's
``batch_wait`` spans in ``Prefetcher`` and ``DecodePool``), over the
window's cells; 0 when the decode always landed first."""
from gwasbench import spans


def read(run):
    if spans.cells(run) <= 0:
        return None
    return spans.ms_per_cell(run, "batch_wait") or 0.0
