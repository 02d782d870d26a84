"""The traced window's share in which no kernel, memcpy or memset ran,
averaged over the run's cards (``trace.busy_s``)."""
from gwasbench import trace


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(run.trace) / run.trace.window_s)
