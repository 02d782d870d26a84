"""Time a slot waits to hand a finished cell to the single consumer (the
port's ``result_wait`` spans: a put onto the full results queue), over the
window's cells; 0 when the queue never filled.  None where the program
records no ``claim`` spans (an untraced run, the serial executor, a program
without the executor's spans)."""
from gwasbench import spans


def read(run):
    if spans.cells(run) <= 0 or spans.delta(run, "claim", "n") <= 0:
        return None
    return spans.ms_per_cell(run, "result_wait") or 0.0
